"""``packed_wgrad_ms.train`` on a synthetic train trace: the device time a
step launched under the six packed sites' ``bwd:<site>/wgrad`` spans,
whatever ran there (library products and their copies, or a hand
kernel), and not the other parts or the std sites' wgrads."""

import json
from pathlib import Path

import pytest

import devtrace
import registry
from test_spans import Trace

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
GEMM = "nvjet_tss_128x128_64x6_2x1_v_bz_splitK_NTT"
COPY = "void at::native::elementwise_kernel<128, 4, direct_copy_kernel>"
TAPS = "void segk::packed_tap_grad_kernel(segk::TapGradParams)"
SUM = "void segk::tap_grad_sum_kernel(float const*, __nv_bfloat16*, int, int)"
DGRAD = "void segk::packed_conv2x2_dgrad_kernel<128, false>"
STD = "sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"


def train_trace():
    """Two steps (µs): conv1_2's wgrad as four products (7 each) and a
    cast (2), conv8_1's as a crop copy (3) and the products (9), conv9_2's
    as the hand kernel (5) and its sum (1); besides, conv9_2's dgrad (10)
    and conv3_1's std wgrad (30), which the metric leaves out."""
    t = Trace()
    for step in range(2):
        at = 1000 * step
        node = t.cpu("autograd::engine::evaluate_function: X", at, at + 900)
        work = [("conv1_2", "wgrad", GEMM, 7)] * 4 + [
            ("conv1_2", "wgrad", COPY, 2), ("conv8_1", "wgrad", COPY, 3),
            ("conv8_1", "wgrad", GEMM, 9), ("conv9_2", "wgrad", TAPS, 5),
            ("conv9_2", "wgrad", SUM, 1), ("conv9_2", "dgrad", DGRAD, 10),
            ("conv3_1", "wgrad", STD, 30)]
        for i, (site, part, kernel, us) in enumerate(work):
            t0 = at + 50 + 60 * i
            span = t.cpu(f"seg:bwd:{site}/{part}", t0, t0 + 40, node)
            op = t.cpu("aten::op", t0 + 1, t0 + 3, span)
            t.launch(op, kernel, t0 + 1, t0 + 10, t0 + 10 + us)
    return t.events


def _rec(trace, config="unet512_bf16"):
    with open(CONFIGS / f"{config}.json") as f:
        cfg = json.load(f)
    return {"cfg": cfg, "batch": 128,
            "trace": {**devtrace.reduce(trace), "units": 2, "window_s": 1.0}}


@pytest.mark.parametrize("config", ["unet512_bf16", "unet512_n64_bf16"])
def test_packed_wgrad_ms_sums_the_packed_sites_wgrads_a_step(config):
    read = registry.reader("packed_wgrad_ms.train")
    assert read(_rec(train_trace(), config)) == pytest.approx(
        (4 * 7 + 2 + 3 + 9 + 5 + 1) / 1e3)


def test_packed_wgrad_ms_reads_none_without_a_trace():
    read = registry.reader("packed_wgrad_ms.train")
    assert read({"cfg": {}, "batch": 128, "trace": None}) is None
    assert devtrace.group_of(TAPS) == devtrace.group_of(SUM) == "other"
