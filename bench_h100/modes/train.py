"""A training cell: Adam steps at the mix's batch through the port's
trainer, the first ``checked_steps`` of them in set-up held against the
plain reference's (check.train_numbers). Its work is one train step; its
control is the reference one precision below (``control["train"]``), and
it also reads the fault "half of the batch left out, the mean over the
rest" (the reference on each batch's first half). A state left unchanged
reads 1 in ``delta_gap`` by its definition and needs no run."""

from __future__ import annotations

import math
import time

import check
import devtrace
import drive
import reference
import systems
import work


def run(cell, seed, seconds, trace, device, plain):
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
    rec = {"set_up_at": time.perf_counter()}
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
    rec["memory_peak_bytes"] = drive.memory_peak(device)
    trainer.close()
    del trainer
    drive.free(device)
    want = check.reference_train(cfg, params, pool[:checked],
                                 block=mix["reference_block"])
    rec["reference"], rec["readings"] = want, got
    return rec, check.train_numbers(got, want)


def least_seconds(cfg: dict, batch: int) -> float:
    """One step of ``batch`` samples: the larger of the compute and the
    byte bound."""
    ops = {p: n * batch for p, n in work.train_ops(cfg).items()}
    return max(work.compute_seconds(ops),
               work.train_bytes(cfg, batch) / work.PEAK_BYTES)


def unit_compute_seconds(cfg: dict, batch: int) -> float:
    """The compute bound alone of one step (what ``mfu`` is measured
    against)."""
    return work.compute_seconds({p: n * batch for p, n in
                                 work.train_ops(cfg).items()})


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


def control_row(cell, seed, rec, n, control_seeds, device) -> dict:
    """Which leaf reads each worst gap and which leaves are left out; on
    the first ``control_seeds`` seeds, the control and the half batch."""
    got, want = rec["readings"], rec["reference"]
    row = {"worst_leaf": {
        k: max(g, key=g.get) for k, g in (
            ("grad1_gap", check.leaf_gaps(got["grad1"], want["grad1"])),
            ("delta_gap", check.leaf_gaps(got["delta"], want["delta"],
                                          check.small_leaves(want))))},
        "small_leaves": sorted(check.small_leaves(want))}
    if n < control_seeds:
        row.update(train_faults(cell, seed, want, device))
    return row
