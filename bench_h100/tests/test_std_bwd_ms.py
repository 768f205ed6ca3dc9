"""``std_bwd_ms.train`` on a synthetic train trace: the device time a step
launched under the std convs' ``bwd:<site>/<part>`` spans, and nothing
where the program opens none of them (a program whose std levels run
their backward under autograd's own nodes)."""

import json
from pathlib import Path

import pytest

import devtrace
import registry
from test_spans import Trace

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
GLUE = "void segk::relu_bias_grad_kernel<false, false>"
DGRAD = "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
WGRAD = "sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
COPY = "void at::native::elementwise_kernel<128, 4, direct_copy_kernel>"


def train_trace(std_spans=True):
    """Two steps (µs). Each: a packed site's ``bwd:conv9_2/dgrad`` (10),
    then conv3_1's three parts (glue 4, dgrad 20, wgrad 30) and conv6_1's
    (glue 2, dgrad 12 and an un-crop copy 3, wgrad 16 and a crop copy 5);
    without the std spans the same activities launch under autograd's
    nodes alone."""
    t = Trace()
    for step in range(2):
        at = 1000 * step
        node = t.cpu("autograd::engine::evaluate_function: X", at, at + 900)
        op = t.cpu("aten::op", at + 2, at + 4,
                   t.cpu("seg:bwd:conv9_2/dgrad", at + 1, at + 50, node))
        t.launch(op, DGRAD, at + 2, at + 10, at + 20)
        work = (("conv3_1", "mask_bias", GLUE, 4),
                ("conv3_1", "dgrad", DGRAD, 20),
                ("conv3_1", "wgrad", WGRAD, 30),
                ("conv6_1", "mask_bias", GLUE, 2),
                ("conv6_1", "dgrad", DGRAD, 12),
                ("conv6_1", "dgrad", COPY, 3),
                ("conv6_1", "wgrad", COPY, 5),
                ("conv6_1", "wgrad", WGRAD, 16))
        for i, (site, part, kernel, us) in enumerate(work):
            t0 = at + 100 + 100 * i
            span = (t.cpu(f"seg:bwd:{site}/{part}", t0, t0 + 50, node)
                    if std_spans else node)
            op = t.cpu("aten::op", t0 + 1, t0 + 3, span)
            t.launch(op, kernel, t0 + 1, t0 + 10, t0 + 10 + us)
    return t.events


def _rec(trace, config="unet512_bf16"):
    with open(CONFIGS / f"{config}.json") as f:
        cfg = json.load(f)
    return {"cfg": cfg, "batch": 128,
            "trace": {**devtrace.reduce(trace), "units": 2, "window_s": 1.0}}


@pytest.mark.parametrize("config", ["unet512_bf16", "unet512_n64_bf16"])
def test_std_bwd_ms_sums_the_std_sites_parts_a_step(config):
    read = registry.reader("std_bwd_ms.train")
    assert read(_rec(train_trace(), config)) == pytest.approx(
        (4 + 20 + 30 + 2 + 12 + 3 + 5 + 16) / 1e3)


def test_std_bwd_ms_reads_none_without_the_std_spans():
    read = registry.reader("std_bwd_ms.train")
    assert read(_rec(train_trace(std_spans=False))) is None
    assert read({"cfg": {}, "batch": 128, "trace": None}) is None
