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
