"""The readings that the limits of ``correct`` are set from, on the chip.

    python3 bench_h100/control.py --workload <name> --seeds 12 \
        --first-seed <n> --seconds 3 --control-seeds 3 --out <file.json>

For each of ``--seeds`` seeds it runs the cell through its mode as run.py
does (a window of ``--seconds``) and records the numbers the program reads
(a serving cell's every statistic of check.request_stats): the lower
readings. The mode's ``control_row`` adds what else a row holds: on the
first ``--control-seeds`` seeds the configuration's control
(``cfg["control"]``) on the same inputs, the program's own
lower-precision route or the reference computed one precision below the
configuration's, and a training cell's faults (modes/train.py).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import run  # sets the import path

import registry  # noqa: E402
import torch  # noqa: E402


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
    mode = registry.mode(cell.mix["mode"])
    rows = []
    for n in range(args.seeds):
        seed = args.first_seed + 7919 * n
        t = time.perf_counter()
        rec, nums = mode.run(cell, seed, args.seconds, 0, device, False)
        row = {"seed": seed, "program": nums,
               "run_s": time.perf_counter() - t}
        row.update(mode.control_row(cell, seed, rec, n, args.control_seeds,
                                    device))
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
