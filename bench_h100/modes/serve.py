"""A served cell: requests of the mix's batch against the configuration's
route, each answer a class map held against the plain f32 reference
(check.sample_stats). Its work is one forward an image; its control is
the configuration's ``control["serve"]``: the program's own lower-precision
route, or the reference computed one precision below."""

from __future__ import annotations

import time

import torch

import check
import devtrace
import drive
import reference
import systems
import work


def run(cell, seed, seconds, trace, device, plain):
    cfg, mix = cell.cfg, cell.mix
    params = reference.make_params(cfg, seed, device)
    calib = systems.calibration(cfg, seed, device)
    server = systems.server(cfg, params, calib, plain)
    pool = drive.serve_inputs(cfg, mix["batch"], mix["pool"], seed, device)
    for x in pool:
        server(x).cpu()
    rec = {"set_up_at": time.perf_counter()}
    rec["window"] = drive.serve_window(server, pool, mix, seconds, seed,
                                       mix["sample"])
    rec["attempted"] = rec["window"]["requests"]
    if trace:
        win, red = devtrace.traced(lambda: drive.serve_window(
            server, pool, mix, mix["trace_seconds"], seed),
            device.type == "cuda")
        rec["trace"] = {**red, "units": win["requests"],
                        "window_s": win["window_s"]}
    rec["memory_peak_bytes"] = drive.memory_peak(device)
    del server
    drive.free(device)
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


def least_seconds(cfg: dict, batch: int) -> float:
    """One request of ``batch`` images: the larger of the compute and the
    byte bound."""
    ops = {p: n * batch for p, n in work.forward_ops(cfg).items()}
    return max(work.compute_seconds(ops),
               work.serve_bytes(cfg, batch) / work.PEAK_BYTES)


def unit_compute_seconds(cfg: dict, batch: int) -> float:
    """The compute bound alone of one request (what ``mfu`` is measured
    against)."""
    return work.compute_seconds({p: n * batch for p, n in
                                 work.forward_ops(cfg).items()})


def serve_control(cell, seed, sample, device) -> dict:
    cfg, ctl = cell.cfg, cell.cfg["control"]["serve"]
    params = reference.make_params(cfg, seed, device)
    pool = drive.serve_inputs(cfg, cell.mix["batch"], cell.mix["pool"], seed,
                              device)
    served = []
    if ctl["kind"] == "program":
        ccfg = {**cfg, "route": ctl["route"]}
        calib = systems.calibration(ccfg, seed, device)
        srv = systems.server(ccfg, params, calib)
        served = [(j, srv(pool[j]).cpu()) for j, _ in sample]
        del srv
    else:
        for j, _ in sample:
            lg = reference.logits(cfg, params, pool[j], ctl["formats"])
            served.append((j, lg.argmax(-1).to(torch.uint8).cpu()))
    return check.worst(check.sample_stats(cfg, params, pool, served,
                                          "gap_ratio" in cell.limits))


def control_row(cell, seed, rec, n, control_seeds, device) -> dict:
    """The control's readings on the run's own sample, on the first
    ``control_seeds`` seeds."""
    if n >= control_seeds:
        return {}
    return {"control": serve_control(cell, seed, rec["window"]["sample"],
                                     device)}
