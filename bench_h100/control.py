"""The readings that the limits of ``correct`` are set from, on the chip.

    python3 bench_h100/control.py --workload <name> --seeds 12 \
        --first-seed <n> --seconds 3 --control-seeds 3 --out <file.json>

For each of ``--seeds`` seeds it runs the cell as run.py does (a window of
``--seconds``) and records the numbers the program reads (a serving
cell's every statistic of check.request_stats): the lower readings. On the first ``--control-seeds`` of them it also reads the
configuration's control (``cfg["control"]``) on the same inputs: the
program's own lower-precision route, or the reference computed one
precision below the configuration's. A training cell also reads the
fault "half of the batch left out, the mean over the rest" (the
reference on each batch's first half). A state left unchanged reads 1 in
``delta_gap`` by its definition and needs no run.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import run  # sets the import path

import check  # noqa: E402
import drive  # noqa: E402
import reference  # noqa: E402
import registry  # noqa: E402
import systems  # noqa: E402
import torch  # noqa: E402


def serve_control(cell, seed, sample, device) -> dict:
    cfg, ctl = cell.cfg, cell.cfg["control"]["serve"]
    params = reference.make_params(cfg, seed, device)
    pool = drive.serve_inputs(cfg, cell.mix["batch"], cell.mix["pool"], seed,
                              device)
    served = []
    if ctl["kind"] == "program":
        route = ctl["route"]
        calib = drive.serve_inputs(cfg, route["calib_batch"],
                                   route["calib_batches"], seed, device,
                                   stream=run.CALIB_STREAM)
        srv = systems.server({**cfg, "route": route}, params, calib)
        served = [(j, srv(pool[j]).cpu()) for j, _ in sample]
        del srv
    else:
        for j, _ in sample:
            lg = reference.logits(cfg, params, pool[j], ctl["formats"])
            served.append((j, lg.argmax(-1).to(torch.uint8).cpu()))
    return check.worst(check.sample_stats(cfg, params, pool, served,
                                          "gap_ratio" in cell.limits))


def train_faults(cell, seed, want, device) -> dict:
    cfg, mix = cell.cfg, cell.mix
    ctl = cfg["control"]["train"]
    params = reference.make_params(cfg, seed, device)
    pool = drive.train_inputs(cfg, mix["batch"], mix["pool"], seed, device)
    batches = pool[:mix["checked_steps"]]
    block = mix["reference_block"]
    out = {}
    t = time.perf_counter()
    got = check.reference_train(cfg, params, batches, ctl["formats"],
                                ctl["grad_format"], block)
    out["control"] = check.train_numbers(got, want)
    out["control_s"] = time.perf_counter() - t
    half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    got = check.reference_train(cfg, params, half, block=block)
    out["half_batch"] = check.train_numbers(got, want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = registry.Cell(args.workload)
    mode = cell.mix["mode"]
    rows = []
    for n in range(args.seeds):
        seed = args.first_seed + 7919 * n
        t = time.perf_counter()
        if mode == "train":
            rec, nums = run.train(cell, seed, args.seconds, 0, device, False)
        else:
            rec, nums = run.serve(cell, seed, args.seconds, 0, device, False)
        row = {"seed": seed, "program": nums,
               "run_s": time.perf_counter() - t}
        if mode == "train":
            got, want = rec["readings"], rec["reference"]
            row["worst_leaf"] = {
                k: max(g, key=g.get) for k, g in (
                    ("grad1_gap", check.leaf_gaps(got["grad1"],
                                                  want["grad1"])),
                    ("delta_gap", check.leaf_gaps(
                        got["delta"], want["delta"],
                        check.small_leaves(want))))}
            row["small_leaves"] = sorted(check.small_leaves(want))
        if n < args.control_seeds:
            if mode == "train":
                row.update(train_faults(cell, seed, rec["reference"], device))
            else:
                row["control"] = serve_control(
                    cell, seed, rec["window"]["sample"], device)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for key in rows[0]["program"]:
        lower = max(r["program"][key] for r in rows)
        uppers = {k: min(r[k][key] for r in rows if k in r)
                  for k in ("control", "half_batch") if k in rows[0]}
        summary[key] = {"lower": lower, "upper": uppers,
                        "ratio": {k: (v / lower if lower > 0 else math.inf)
                                  for k, v in uppers.items()}}
    print(json.dumps({"summary": summary}))
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "rows": rows,
                   "summary": summary, "card": run._card()}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
