"""work.py's counts against the figures the port's records give for the
flagship U-Net (PERF.md §6's bound arithmetic)."""

import json
from pathlib import Path

import pytest

import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    with open(CONFIGS / f"{name}.json") as f:
        return json.load(f)


STD_SINGLE = ["conv3_1", "conv3_2", "conv4_1", "conv4_2", "conv5_1",
              "conv5_2", "conv6_2", "conv7_2"]
STD_DUAL = ["conv6_1", "conv7_1"]


def test_forward_is_56_3_gflop_an_image():
    ops = work.forward_ops(_cfg("unet512_bf16"))
    assert set(ops) == {"bf16"}
    assert ops["bf16"] / 1e9 == pytest.approx(56.3, abs=0.05)


def test_int8_std_levels_bound_at_b8_is_h8s():
    layers = {l["name"]: l for l in work.layers(_cfg("unet512_int8"))}
    assert all(layers[n]["precision"] == "s8" for n in STD_SINGLE + STD_DUAL)
    ms = lambda names: sum(work.layer_ops(layers[n]) for n in names) * 8 \
        / work.PEAK_OPS["s8"] * 1e3
    assert ms(STD_SINGLE) == pytest.approx(0.085, abs=0.0005)
    assert ms(STD_DUAL) == pytest.approx(0.038, abs=0.0005)
    assert ms(STD_SINGLE + STD_DUAL) == pytest.approx(0.122, abs=0.001)


def test_train_step_is_forward_wgrads_and_dgrads_but_the_first():
    cfg = _cfg("unet512_bf16")
    layers = work.layers(cfg)
    fwd = sum(work.layer_ops(l) for l in layers)
    train = work.train_ops(cfg)["bf16"]
    assert train == pytest.approx(3 * fwd - work.layer_ops(layers[0]))
    assert layers[0]["name"] == "conv1_1"
    assert train / 1e9 == pytest.approx(168.5, abs=0.1)


def test_shapes_follow_the_valid_unet():
    layers = work.layers(_cfg("unet512_bf16"))
    assert len(layers) == 23
    assert layers[-1]["name"] == "output" and layers[-1]["out"] == (324, 324)
    assert {l["name"]: l["cout"] for l in layers}["conv5_2"] == 512


def test_int8_route_states_each_layers_precision():
    cfg = _cfg("unet512_int8")
    prec = {l["name"]: l["precision"] for l in work.layers(cfg)}
    assert {n for n, p in prec.items() if p == "bf16"} == {
        "conv1_1", "upconv1", "upconv2", "output"}
    ops = work.forward_ops(cfg)
    assert ops["s8"] + ops["bf16"] == pytest.approx(
        sum(work.forward_ops(_cfg("unet512_bf16")).values()))


@pytest.mark.parametrize("mode,batch", [("train", 128), ("serve", 8),
                                        ("serve", 64)])
def test_least_time_bounds_compute_and_bytes(mode, batch):
    for name in ("unet512_bf16", "unet512_int8"):
        cfg = _cfg(name)
        least = work.least_seconds(cfg, mode, batch)
        assert least >= work.unit_compute_seconds(cfg, mode, batch) > 0
        nbytes = (work.train_bytes(cfg, batch) if mode == "train"
                  else work.serve_bytes(cfg, batch))
        assert least >= nbytes / work.PEAK_BYTES


def _bench():
    with open(CONFIGS.parents[1] / "BENCHMARK.json") as f:
        return json.load(f)


def _program_sites(cfg, mode):
    """The site spans the program opens for a cell (PERF.md §3's span
    table): one per layer, the int8 route's fused level 1, serving's head
    folded into conv9_2, and the sites that compute no published layer."""
    names = [l["name"] for l in work.layers(cfg)]
    sites = [n for n in names if n != "output"]
    if mode == "train":
        return sites + ["head", "std_pool", "input", "loss", "pack_weights"]
    if cfg["route"]["kind"] == "int8":
        sites = ["conv1_1+conv1_2"] + sites[2:]
    return [s if s != "conv9_2" else "conv9_2+head" for s in sites] + [
        "std_pool", "unpack"]


def _site_ops(cfg, sites, parts):
    ops = {}
    for site in sites:
        for layer in work.site_layers(cfg, site):
            for part in parts:
                ops[layer["precision"]] = (ops.get(layer["precision"], 0.0)
                                           + work.part_ops(layer, part))
    return ops


@pytest.mark.parametrize("workload", [w["name"]
                                      for w in _bench()["workloads"]])
def test_sites_partition_each_cells_work(workload):
    """Over the sites of a cell's spans, the forward parts sum to
    forward_ops and, in training, forward + dgrad + wgrad to train_ops."""
    entry = [w for w in _bench()["workloads"] if w["name"] == workload][0]
    cfg = _cfg(entry["config"])
    mode = "train" if entry["traffic"].startswith("train") else "serve"
    sites = _program_sites(cfg, mode)
    got = _site_ops(cfg, sites, ["fwd"])
    assert got == pytest.approx(work.forward_ops(cfg))
    if mode == "train":
        assert _site_ops(cfg, sites, work.PARTS) == pytest.approx(
            work.train_ops(cfg))


def test_sites_without_a_layer_name_none():
    cfg = _cfg("unet512_bf16")
    for site in ("std_pool", "unpack", "input", "loss", "pack_weights",
                 "(no site)"):
        assert work.site_layers(cfg, site) == []
    assert [l["name"] for l in work.site_layers(cfg, "conv9_2+head")] == [
        "conv9_2", "output"]
    assert [l["name"] for l in work.site_layers(cfg, "head")] == ["output"]


@pytest.mark.parametrize("part", work.PARTS)
def test_a_sites_least_time_bounds_compute_and_bytes(part):
    cfg = _cfg("unet512_int8")
    for layer in work.layers(cfg):
        least = work.layer_least_s(layer, part, 64)
        assert least >= work.part_ops(layer, part) * 64 / work.PEAK_OPS[
            layer["precision"]]
        assert least >= work.layer_bytes(layer, part, 64) / work.PEAK_BYTES
    assert work.layer_least_s(work.layers(cfg)[0], "dgrad", 64) == 0.0


def test_a_fused_chain_skips_its_intermediate():
    """H5's conv1_1+conv1_2 neither writes nor reads conv1_1's output, so
    the chain's bound lies under the sum of its layers' and over its
    compute bound."""
    cfg = _cfg("unet512_int8")
    c1, c2 = work.site_layers(cfg, "conv1_1+conv1_2")
    chain = work.site_least_s(cfg, "conv1_1+conv1_2", "fwd", 64)
    assert chain < (work.layer_least_s(c1, "fwd", 64)
                    + work.layer_least_s(c2, "fwd", 64))
    assert chain >= sum(work.layer_ops(l) * 64 / work.PEAK_OPS[
        l["precision"]] for l in (c1, c2))


def test_h8_sites_least_time_at_b64():
    """The ten std 3x3 conv sites of a bf16 B = 64 request: 1.96 ms, all
    bound by the bf16 peak."""
    cfg = _cfg("unet512_bf16")
    least = sum(work.site_least_s(cfg, s, "fwd", 64)
                for s in STD_SINGLE + STD_DUAL)
    assert least * 1e3 == pytest.approx(1.958, abs=0.001)
