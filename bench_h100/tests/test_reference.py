"""The plain reference's two-class difference head: the class map that the
stated-precision computation of ``gap_ratio`` serves."""

import json
from pathlib import Path

import torch

import reference

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TINY = {"input_dims": [188, 188], "n_kernels": 8}


def _tiny():
    with open(CONFIGS / "unet512_bf16.json") as f:
        return {**json.load(f), **TINY}


def test_diff_head_in_f32_is_the_logit_difference():
    cfg = _tiny()
    params = reference.make_params(cfg, 11, "cpu")
    x = torch.rand((2, 188, 188, 3), generator=torch.Generator().manual_seed(3))
    full = reference.logits(cfg, params, x)
    diff = reference.logits(cfg, params, x, diff_head=True)
    assert torch.equal(diff[..., 0], torch.zeros_like(diff[..., 0]))
    torch.testing.assert_close(diff[..., 1], full[..., 1] - full[..., 0],
                               rtol=0, atol=1e-5)


def test_diff_head_rounds_the_weight_difference_once():
    cfg = _tiny()
    params = reference.make_params(cfg, 12, "cpu")
    h = torch.rand((1, cfg["n_kernels"], 4, 4))
    net = reference.UNetRef(cfg, params, {"default": "bf16"}, diff_head=True)
    w, b = params["output/w"][0, 0], params["output/b"]
    wd = (w[:, 1] - w[:, 0]).to(torch.bfloat16).float()
    want = torch.einsum("nchw,c->nhw", h.to(torch.bfloat16).float(), wd) \
        + (b[1] - b[0])
    got = net._diff_head(h)
    assert got.shape == (1, 2, 4, 4)
    torch.testing.assert_close(got[:, 1], want, rtol=0, atol=1e-6)
