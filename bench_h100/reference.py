"""The plain reference of the benchmark's U-Net: weights drawn from the
seed, the f32 forward, the training loss and Adam, and the lower-precision
controls. Plain PyTorch only: it imports nothing of the program under
test, so nothing the program makes (packed weights, scales, tables) can
reach it.

The network is the VALID U-Net of Ronneberger et al. (arXiv:1505.04597)
as nathanin/segmentation's ``models/unet.py`` builds it: per level two 3×3
convs with ReLU, a 2×2/2 max pool; a bottleneck of two 3×3 convs; per up
level a 2×2/2 transposed conv with ReLU, the skip center-cropped
(offset = excess // 2) and concatenated before the up path, two 3×3 convs
with ReLU; a 1×1 class head. Weights are HWIO under the names
``conv1_1/w``, ``upconv1/b``, ``output/w``, …

Lower precision (the controls of ``correct``, and the stated precision
that ``gap_ratio`` divides by) is simulated: each conv's input and weight
are rounded to the format (bf16 as is; the others with a per-tensor
(activations) or per-output-channel (weights) scale from their own
absolute maximum) and the product is taken in f32; in training the gradient at each conv's
output is rounded the same way on the way back.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one purpose (weights, inputs, sampling) of a run."""
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def param_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    """(name, HWIO shape) of every parameter, in declaration order."""
    k, levels, out = cfg["n_kernels"], cfg["levels"], []

    def conv(name, ci, co, ksz=3):
        out.extend([(f"{name}/w", (ksz, ksz, ci, co)), (f"{name}/b", (co,))])

    c = cfg["input_channel"]
    for lvl in range(levels):
        conv(f"conv{lvl + 1}_1", c, k * 2**lvl)
        conv(f"conv{lvl + 1}_2", k * 2**lvl, k * 2**lvl)
        c = k * 2**lvl
    conv(f"conv{levels + 1}_1", c, k * 2**levels)
    conv(f"conv{levels + 1}_2", k * 2**levels, k * 2**levels)
    c = k * 2**levels
    for i, lvl in enumerate(reversed(range(levels))):
        width = k * 2**lvl
        conv(f"upconv{i + 1}", c, width, ksz=2)
        conv(f"conv{levels + 2 + i}_1", 2 * width, width)
        conv(f"conv{levels + 2 + i}_2", width, width)
        c = width
    conv("output", c, cfg["n_classes"], ksz=1)
    return out


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights from ``seed``, drawn on ``device`` in one call: weights
    xavier-uniform (the model's initializer), biases uniform in
    ±``cfg["init"]["bias"]``. Then the head's bias is set so that the
    median pixel of one seeded uniform image lies on the boundary between
    the first two classes: with random weights every ReLU feature is
    positive and the logits share one offset, which would otherwise give
    nearly every pixel one class, and the class maps would say little."""
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 0))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    bias = float(cfg["init"]["bias"])
    out = {}
    for (name, shape), part in zip(shapes, torch.split(u, sizes)):
        if name.endswith("/w"):
            fan_in = math.prod(shape[:-1])
            fan_out = math.prod(shape[:-2]) * shape[-1]
            scale = math.sqrt(6.0 / (fan_in + fan_out))
        else:
            scale = bias
        out[name] = (part * scale).view(shape)
    h, w = cfg["input_dims"]
    x = torch.rand((1, h, w, cfg["input_channel"]), generator=gen,
                   device=device)
    lg = logits(cfg, out, x)
    out["output/b"][1] -= (lg[..., 1] - lg[..., 0]).median()
    return out


# ---- lower precision ------------------------------------------------------
_FP8 = {"fp8": (torch.float8_e4m3fn, 448.0), "fp8_grad": (torch.float8_e5m2,
                                                          57344.0)}
_INT = {"int8": 127.0, "int4": 7.0}


def round_to(x: torch.Tensor, fmt: Optional[str], dim=None) -> torch.Tensor:
    """``x`` rounded to ``fmt`` (None, "bf16", "fp8", "fp8_grad", "int8",
    "int4"), the scaled formats with a scale from its absolute maximum, per
    tensor or, with ``dim``, per slice along ``dim``; returned in f32."""
    if fmt is None:
        return x
    x = x.float()
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    if dim is None:
        amax = x.abs().amax()
    else:
        keep = [d for d in range(x.ndim) if d != dim]
        amax = x.abs().amax(dim=keep, keepdim=True)
    if fmt in _FP8:
        dtype, top = _FP8[fmt]
        scale = torch.clamp(amax, min=1e-30) / top
        return (x / scale).to(dtype).float() * scale
    top = _INT[fmt]
    scale = torch.clamp(amax, min=1e-30) / top
    return torch.clamp(torch.round(x / scale), -top, top) * scale


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to ``fmt``."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.fmt), None


class _RoundFwd(torch.autograd.Function):
    """``x`` rounded to ``fmt``; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x, fmt, dim):
        return round_to(x, fmt, dim)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _rq(x, fmt, dim=None):
    if fmt is None:
        return x
    return _RoundFwd.apply(x, fmt, dim)


# ---- the network ------------------------------------------------------------
class UNetRef:
    """The plain U-Net over NHWC inputs and HWIO weights. ``formats`` maps
    a layer name (or ``"default"``) to the format its input and weight are
    rounded to (absent: f32); ``grad_format`` rounds each conv's output
    gradient. ``diff_head`` (two classes) takes the head as the one logit
    difference a served class map needs: the weight difference w1 − w0
    rounded once, logits [0, d]; the class is the same argmax."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 formats: Optional[Dict[str, str]] = None,
                 grad_format: Optional[str] = None, diff_head: bool = False):
        self.cfg, self.p = cfg, params
        self.formats = formats or {}
        self.grad_format = grad_format
        self.diff_head = diff_head

    def _layer(self, name, h, op, **kw):
        fmt = self.formats.get(name, self.formats.get("default"))
        w = self.p[f"{name}/w"]
        if op is F.conv_transpose2d:
            wt, wdim = w.permute(2, 3, 0, 1), 1   # [C, O, kh, kw]
        else:
            wt, wdim = w.permute(3, 2, 0, 1), 0   # [O, C, kh, kw]
        y = op(_rq(h, fmt), _rq(wt, fmt, wdim), self.p[f"{name}/b"], **kw)
        if self.grad_format is not None and y.requires_grad:
            y = _RoundGrad.apply(y, self.grad_format)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, C] (any float dtype) → f32 logits [N, h, w, C']."""
        L = self.cfg["levels"]
        h = x.float().permute(0, 3, 1, 2)
        conv = lambda name, t: torch.relu(self._layer(name, t, F.conv2d))
        skips = []
        for lvl in range(L):
            h = conv(f"conv{lvl + 1}_2", conv(f"conv{lvl + 1}_1", h))
            skips.append(h)
            h = F.max_pool2d(h, 2)
        h = conv(f"conv{L + 1}_2", conv(f"conv{L + 1}_1", h))
        for i, lvl in enumerate(reversed(range(L))):
            h = torch.relu(self._layer(f"upconv{i + 1}", h,
                                       F.conv_transpose2d, stride=2))
            s = skips[lvl]
            hh, ww = h.shape[2], h.shape[3]
            oy, ox = (s.shape[2] - hh) // 2, (s.shape[3] - ww) // 2
            s = s[:, :, oy:oy + hh, ox:ox + ww]
            h = torch.cat([s, h], dim=1)
            h = conv(f"conv{L + 2 + i}_2", conv(f"conv{L + 2 + i}_1", h))
        y = (self._diff_head(h) if self.diff_head
             else self._layer("output", h, F.conv2d))
        return y.permute(0, 2, 3, 1)

    def _diff_head(self, h):
        fmt = self.formats.get("output", self.formats.get("default"))
        w, b = self.p["output/w"], self.p["output/b"]
        wd = (w[0, 0, :, 1] - w[0, 0, :, 0]).view(1, -1, 1, 1)
        d = F.conv2d(_rq(h, fmt), _rq(wd, fmt, 0), (b[1] - b[0]).view(1))
        return torch.cat([torch.zeros_like(d), d], dim=1)


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def logits(cfg, params, x, formats=None, block: int = 8,
           diff_head: bool = False) -> torch.Tensor:
    """f32 logits of ``x`` in blocks of ``block`` images."""
    net = UNetRef(cfg, params, formats, diff_head=diff_head)
    with torch.no_grad(), exact_f32():
        return torch.cat([net.forward(x[i:i + block])
                          for i in range(0, x.shape[0], block)])


# ---- training ---------------------------------------------------------------
def xentropy(logits_: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of [N, h, w, C] logits against [N, H, W,
    1] integer masks center-cropped to h × w (offset = excess // 2)."""
    n, h, w, c = logits_.shape
    oy, ox = (masks.shape[1] - h) // 2, (masks.shape[2] - w) // 2
    m = masks[:, oy:oy + h, ox:ox + w, 0].long()
    logp = F.log_softmax(logits_.float(), dim=-1)
    return -logp.gather(-1, m[..., None]).mean()


def to_input(image_u8: torch.Tensor) -> torch.Tensor:
    """The trainer's input rule: u8 pixels times f32(1/255)."""
    return image_u8.float() * np.float32(1.0 / 255.0)


def loss_and_grads(cfg, params, batch, formats=None, grad_format=None,
                   block: int = 16):
    """(mean loss, {name: grad}) of one batch, summed over blocks of
    ``block`` images (each block's mean weighted by its share)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    net = UNetRef(cfg, leaves, formats, grad_format)
    n, total = batch["image"].shape[0], 0.0
    with exact_f32():
        for i in range(0, n, block):
            img = batch["image"][i:i + block]
            part = xentropy(net.forward(to_input(img)),
                            batch["mask"][i:i + block])
            (part * (img.shape[0] / n)).backward()
            total += float(part.detach()) * img.shape[0] / n
    return total, {k: v.grad for k, v in leaves.items()}


class Adam:
    """Adam as optax.adam (and torch.optim.Adam) computes it: ε added after
    the bias-corrected square root."""

    def __init__(self, params, lr, beta1, beta2, eps):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.b1, self.b2, self.eps, self.t = lr, beta1, beta2, eps, 0

    def step(self, grads) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            den = (self.v[k] / c2).sqrt_().add_(self.eps)
            self.p[k].addcdiv_(self.m[k], den, value=-self.lr / c1)


def train_readings(cfg, params, batches, formats=None, grad_format=None,
                   block: int = 16):
    """What ``correct`` compares of a training run, from the reference:
    the loss of each step, each leaf's first gradient, and each leaf's
    change after len(batches) Adam steps."""
    opt = Adam(params, **cfg["train"])
    losses, first = [], None
    for batch in batches:
        loss, grads = loss_and_grads(cfg, opt.p, batch, formats, grad_format,
                                     block)
        losses.append(loss)
        if first is None:
            first = grads
        opt.step(grads)
    delta = {k: opt.p[k] - params[k] for k in params}
    return {"losses": losses, "grad1": first, "delta": delta}
