"""The Bayesian U-Net's MC cell on the CPU: its files resolve, run.py's
rehearsal prints the contract's line for it, traced and untraced, its work
count is pinned (the encoder once and the decoder S times: 1,508.5 GFLOP
a 1024² tile), the route's plain server and reference_mc.py draw the same
masks and agree, and both faults of ``modes/serve_mc.py`` fail
``correct`` under the cell's limits while a sound run passes them. The
program is reached only through ``systems`` and ``routes``."""

import json

import pytest
import torch

import check
import registry
import reference
import reference_mc
import run
import systems
import work
import work_mc

CELL = "unet1024_mc8_bf16.serve_mc8_b2"
# one 1024² tile: 125.446576896 GFLOP of encoder, 8 × 172.87877632 of
# decoder (work.layers at n_kernels 32)
TILE_OPS = 1508476787456.0
SEEDS = [2147483659 + 7919 * n for n in range(3)]


def _cell(small=True):
    cell = registry.Cell(CELL)
    if small:
        cell.cfg.update(run.REHEARSAL)
        cell.mix.update({k: v for k, v in run.REHEARSAL_MIX.items()
                         if k in cell.mix})
    return cell


def test_the_cell_resolves_from_its_files():
    cell = registry.Cell(CELL)
    assert cell.cfg["input_dims"] == [1024, 1024] and cell.cfg["reduced"] == []
    assert cell.cfg["n_kernels"] == 32 and cell.cfg["levels"] == 4
    assert cell.cfg["route"] == {"kind": "bf16_mc", "mc_samples": 8,
                                 "dropout_rate": 0.5}
    assert cell.mix["mode"] == "serve_mc" and cell.mix["batch"] == 2
    assert set(cell.limits) == {"mc_gap_ratio", "mask_gap"}
    names = [n for n, _, _ in cell.end_to_end + cell.per_layer]
    assert names[:2] == ["serve_img_per_s", "setup_s"]
    assert {"mfu.mc", "idle_share.mc", "launch_calls.mc", "mc_decoder_ms.mc",
            "mc_decoder_roofline.mc", "mc_fanout_roofline.mc",
            "mc_head_roofline.mc", "mc_moments_roofline.mc"} <= set(names)


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_the_line(trace, capsys):
    rc = run.main(["--workload", CELL, "--seed", str(2**31 + 23),
                   "--seconds", "0.3", "--trace", str(trace), "--rehearse"])
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device",
            "checks"} <= set(line)
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    assert line["correct"] is True and line["failed"] == 0
    cell = registry.Cell(CELL)
    names = [n for n, _, _ in (cell.per_layer if trace else cell.end_to_end)]
    assert list(line["metrics"]) == names
    assert all(m["value"] is None for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits)
    for name in line["checks"]:
        assert f"check {name}: " in err


def test_the_work_count_is_the_encoder_once_and_the_decoder_s_times():
    cfg = registry.Cell(CELL).cfg
    assert work_mc.tile_ops(cfg) == {"bf16": TILE_OPS}
    enc, dec = work_mc.split(cfg)
    assert enc[-1]["name"] == "conv5_2" and dec[-1]["name"] == "output"
    whole = 8 * sum(work.forward_ops(cfg).values())
    assert 1.58 < whole / TILE_OPS < 1.59
    mode = registry.mode("serve_mc")
    assert mode.unit_compute_seconds(cfg, 2) == 2 * TILE_OPS / 989e12
    assert work.unit_compute_seconds(cfg, "serve_mc", 2) == \
        2 * TILE_OPS / 989e12
    assert mode.least_seconds(cfg, 2) >= mode.unit_compute_seconds(cfg, 2)
    assert work_mc.decoder_sites(cfg)[-1] == "conv9_2+mc_head"


def test_the_reference_draws_the_programs_masks():
    """reference_mc's stream against the program's (through the route's
    server: its model's plain ops draw nn/mc_mask.py's bits), element for
    element, over both sites, several samples and tiles and a seed of both
    words."""
    cfg = _cell().cfg
    params = reference.make_params(cfg, 5, "cpu")
    srv = systems.server(cfg, params, [], plain=True)
    x = torch.ones((2, 4, 4, 16), dtype=torch.bfloat16)
    seed = 2**40 + 2**31 + 77
    got = srv.model.ops.mc_fanout(x, seed=seed, samples=3, rate=0.5)
    for s in range(3):
        for n in range(2):
            want = reference_mc.multiplier(seed, reference_mc.BOTTLENECK, s,
                                           n, (4, 4, 16), 0.5, "cpu")
            assert torch.equal(got[s * 2 + n].float(), want)


def test_the_plain_server_agrees_with_the_reference():
    cell = _cell()
    cfg, mode = cell.cfg, registry.mode("serve_mc")
    params = reference.make_params(cfg, SEEDS[0], "cpu")
    srv = systems.server(cfg, params, [], plain=True)
    x = torch.rand((2, 188, 188, 3), generator=torch.Generator().manual_seed(
        3)).to(torch.bfloat16)
    mean, var, cmap = srv(2**33 + 9, x)
    ref = reference_mc.moments(reference_mc.sampled_probs(
        cfg, params, x, 2**33 + 9, 8, 0.5))
    assert (mean - ref[0]).abs().max() < 2e-2
    assert (var - ref[1]).abs().max() < 2e-2
    st = mode.request_stats(cfg, params, x, 2**33 + 9, (mean, var, cmap))
    assert st["mc_gap_ratio"] < cell.limits["mc_gap_ratio"]
    assert st["mask_gap"] < cell.limits["mask_gap"]


@pytest.mark.parametrize("seed", SEEDS)
def test_both_faults_fail_correct(seed):
    """A sound rehearsal run passes the cell's limits; the program with the
    decoder-end mask left off, and with one sample's masks for all S,
    fails them, on the run's own sample."""
    cell = _cell()
    mode = registry.mode("serve_mc")
    rec, nums = mode.run(cell, seed, 0.3, 0, torch.device("cpu"), True)
    assert check.verdict(nums, cell.limits)[0]
    faults = mode.fault_stats(cell, seed, rec["window"]["sample"],
                              torch.device("cpu"), plain=True)
    assert set(faults) == {"fault_head_mask_off", "fault_one_sample"}
    for name, got in faults.items():
        assert not check.verdict(got, cell.limits)[0], (name, got)
