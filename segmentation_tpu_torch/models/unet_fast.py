"""Space-to-depth U-Net serving forward (segmentation_tpu.models.unet_fast).

The same network as models.unet.UNet, on the same params, with the two top
levels (C = k, 2k) and their two decoder blocks in the packed layout
[N, H/2, W/2, 4C] (slot-major, s = 2·dy + dx):

  3×3 VALID conv, unpacked in → packed out   = 4×4/2 conv (H3)
  3×3 VALID conv, packed → packed            = 2×2 conv over 4C → 4O (H1)
  2×2/2 max pool                             = max over the 4 slots (H1)
  2×2/2 transposed conv                      = per-pixel [C] → [4O] (H4)
  crop + concat + 3×3 conv                   = concat-free dual conv (H2)
  1×1 head + argmax, n_classes = 2           = sign of one dot (H1)

The standard levels (3–5) run unpacked: their 3×3 convs on H8's bf16
mode (``ops.std_conv3x3``, ``ops.std_conv3x3_dual``: bias and ReLU fused,
the decoder's skip cropped in the kernel's loads), where the JAX package
leaves them to XLA; upconv1/2, the std pool and the 1×1 head of ``apply``
stay plain PyTorch ops. This is the JAX 4-D ``apply`` topology; the
padded-flat (PadFlat/PF2) layouts and their gates are TPU devices and are
not ported. Each packed site calls one op of ``ops``:
the hand kernels by default, their plain versions with ``PLAIN_OPS``.
Every conv site goes through a hook method (``_strided``, ``_conv_pool``,
``_dual``, ...), which the int8 subclass (models/unet_int8.py) and the
training hooks (``UNetS2DTrain``) override. ``apply`` runs each site in
the span ``fwd:<site>`` (utils/trace.py), a fused kernel in one span named
for the sites it fuses (``fwd:conv9_2+head``), so that the subclasses
inherit the spans with the forward.

The site layout lives in one table, ``UNetSites`` (``unet_sites``, built
once per model as ``sites``): which conv is an entry, packed, dual,
upconv or std site, each decoder conv's skip and each site's consumer.
The packed format is made by one function, ``pack_sites`` (the gathers
``pack_conv3_weight_t`` / ``pack_conv3_weight_s2_t``): serving's
``prepare`` runs it once on the host, the trainable model every step.

``UNetS2D`` is the trainable model: an ``nn.Module`` holding the f32 U-Net
params, whose forward packs the weights differentiably (a gather of the
[3, 3, C, O] kernels) and runs ``apply`` through the train hooks: each
packed site a ``torch.autograd.Function`` of nn/kernels/train.py (H1–H4
forward, H6 input grads, the glue kernels of nn/kernels/train_glue.py),
each level's pool fused into its conv with an argmax index, as
``pool4_select`` computes it; each standard level's 3×3 conv one too (H8
forward, the glue's mask and bias grad, cuDNN's dgrad and wgrad).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from segmentation_tpu_torch.core.config import ModelConfig
from segmentation_tpu_torch.core.rng import generator
from segmentation_tpu_torch.models.unet import init_params, unet_param_shapes
from segmentation_tpu_torch.nn.kernels import train as kt
from segmentation_tpu_torch.nn.kernels.conv_flat import (
    KERNEL_OPS,
    Ops,
    pool_select,
)
from segmentation_tpu_torch.nn.kernels.train_glue import pool_scatter
from segmentation_tpu_torch.nn.layers import conv2d_transpose, max_pool
from segmentation_tpu_torch.nn.packing import (  # noqa: F401 (re-export)
    crop_packed,
    pack2,
    unpack2,
    view5,
)
from segmentation_tpu_torch.nn.shapes import unet_output_hw
from segmentation_tpu_torch.utils import trace


@functools.lru_cache(None)
def _pack_index(s2: bool, device: torch.device):
    """(ky, kx, valid) of the packed kernels, built once per device: tap
    (ky, kx) of the [3, 3, C, O] kernel that each packed (position, slot
    pair) reads, and whether it lies in the 3×3 window.
      2×2 over 4C → 4O: [u, v, s_in, s_out], ky = 2u + a - d, kx = 2v + b - e
      4×4/2 → 4O:      [u, v, s_out],       ky = u - d,      kx = v - e
    with slots s_in = 2a + b, s_out = 2d + e."""
    if s2:
        u, v, s = np.ix_(range(4), range(4), range(4))
        ky, kx = u - s // 2, v - s % 2
    else:
        u, v, si, so = np.ix_(range(2), range(2), range(4), range(4))
        ky, kx = 2 * u + si // 2 - so // 2, 2 * v + si % 2 - so % 2
    valid = (ky >= 0) & (ky < 3) & (kx >= 0) & (kx < 3)
    return tuple(torch.as_tensor(a, device=device) for a in
                 (np.clip(ky, 0, 2), np.clip(kx, 0, 2), valid))


def _gather_taps(w: torch.Tensor, s2: bool) -> torch.Tensor:
    ky, kx, valid = _pack_index(s2, w.device)
    taps = w[ky, kx]  # [..index.., C, O]
    return torch.where(valid[..., None, None], taps, taps.new_zeros(()))


def pack_conv3_weight_t(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, O] → [2, 2, 4C, 4O] packed-space kernel, a differentiable
    gather + mask: W2[u, v, (a,b,c), (d,e,o)] = W[2u+a-d, 2v+b-e, c, o]
    where both tap indices land in [0, 3), else 0
    (segmentation_tpu.models.unet_fast.pack_conv3_weight)."""
    c, o = w.shape[2], w.shape[3]
    w2 = _gather_taps(w, False)  # [u, v, s_in, s_out, C, O]
    return w2.permute(0, 1, 2, 4, 3, 5).reshape(2, 2, 4 * c, 4 * o)


def pack_conv3_weight_s2_t(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, O] → [4, 4, C, 4O] stride-2 kernel, a differentiable
    gather + mask: K[u, v, c, (2d+e)·O + o] = W[u-d, v-e, c, o] where the
    tap is in [0, 3), else 0 (segmentation_tpu.models.unet_fast.
    pack_conv3_weight_s2)."""
    c, o = w.shape[2], w.shape[3]
    w4 = _gather_taps(w, True)  # [u, v, s_out, C, O]
    return w4.permute(0, 1, 3, 2, 4).reshape(4, 4, c, 4 * o)


@dataclasses.dataclass(frozen=True)
class UNetSites:
    """The conv sites of the packed U-Net, by name and role (``unet_sites``
    builds it once per model). ``encoder``: (conv_1, conv_2) of each level,
    the bottleneck's last; ``decoder``: (level, upconv, conv_1, conv_2),
    the deepest first. The packed levels' sites: ``entry`` (the 3×3 conv
    into the packed layout, H3), ``packed`` (packed 2×2 convs, H1),
    ``dual`` (the decoder's concat-free first convs, H2) and ``ups`` (their
    upconvs, H4); the standard levels' 3×3 convs ``std`` (H8), the
    decoder's duals ``std_dual`` among them. ``skip``: each decoder conv_1
    → the encoder conv whose output is its skip. ``consumer``: each site →
    the site that reads its output (an upconv's: its dual's up side), the
    int8 scale graph's edges."""

    encoder: Tuple[Tuple[str, str], ...]
    decoder: Tuple[Tuple[int, str, str, str], ...]
    entry: Tuple[str, ...]
    packed: Tuple[str, ...]
    dual: Tuple[str, ...]
    ups: Tuple[str, ...]
    std: Tuple[str, ...]
    std_dual: Tuple[str, ...]
    skip: Dict[str, str]
    consumer: Dict[str, str]

    @property
    def packed_sites(self) -> Tuple[str, ...]:
        """Every site with packed weights and a tiled bias ``b4``."""
        return self.entry + self.packed + self.dual + self.ups


def unet_sites(levels: int, packed_levels: int) -> UNetSites:
    """The site table of a U-Net of ``levels`` levels, the first
    ``packed_levels`` of them packed."""
    L, pl_ = levels, packed_levels
    enc = tuple((f"conv{lvl + 1}_1", f"conv{lvl + 1}_2")
                for lvl in range(L + 1))
    dec = tuple((lvl, f"upconv{i + 1}", f"conv{L + 2 + i}_1",
                 f"conv{L + 2 + i}_2")
                for i, lvl in enumerate(reversed(range(L))))
    pdec = [d for d in dec if d[0] < pl_]
    sdec = [d for d in dec if d[0] >= pl_]
    order = [n for pair in enc for n in pair] + [
        n for _, up, c1, c2 in dec for n in (up, c1, c2)]
    return UNetSites(
        encoder=enc, decoder=dec,
        entry=tuple(c1 for c1, _ in enc[:pl_]),
        packed=tuple(c2 for _, c2 in enc[:pl_])
        + tuple(c2 for *_, c2 in pdec),
        dual=tuple(c1 for _, _, c1, _ in pdec),
        ups=tuple(up for _, up, _, _ in pdec),
        std=tuple(n for pair in enc[pl_:] for n in pair)
        + tuple(n for _, _, c1, c2 in sdec for n in (c1, c2)),
        std_dual=tuple(c1 for _, _, c1, _ in sdec),
        skip={c1: enc[lvl][1] for lvl, _, c1, _ in dec},
        consumer=dict(zip(order, order[1:])))


def packed_wgrad_sites(hw: Tuple[int, int], levels: int, n_kernels: int
                       ) -> Dict[str, tuple]:
    """The operands of each packed 2×2 site's weight gradient (the
    ``packed`` and ``dual`` sites, in the network's order) for an ``hw``
    input: site → (x's packed grid [hp, wp], which is also its cotangent
    buffer's; 4C of a side; the dual's skip grid and crop offset in
    unpacked pixels, else None and None)."""
    sites = unet_sites(levels, min(2, levels))
    size, skip_out, h = {}, {}, tuple(hw)  # each conv's unpacked input
    for lvl, (c1, c2) in enumerate(sites.encoder):
        size[c1], size[c2] = h, tuple(d - 2 for d in h)
        skip_out[c2] = h = tuple(d - 4 for d in h)
        h = tuple(d // 2 for d in h)
    h = skip_out[sites.encoder[-1][1]]
    level = {c2: lvl for lvl, (_, c2) in enumerate(sites.encoder)}
    for lvl, _, c1, c2 in sites.decoder:
        h = tuple(2 * d for d in h)
        size[c1], size[c2], level[c1], level[c2] = (
            h, tuple(d - 2 for d in h), lvl, lvl)
        h = tuple(d - 4 for d in h)
    out = {}
    for name in (n for n in size if n in sites.packed + sites.dual):
        skip = sites.skip.get(name)
        grid = tuple(d // 2 for d in size[name])
        out[name] = (grid, 4 * n_kernels * 2**level[name],
                     None if skip is None else
                     tuple(d // 2 for d in skip_out[skip]),
                     None if skip is None else
                     tuple((s - d) // 2
                           for s, d in zip(skip_out[skip], size[name])))
    return out


def pack_sites(sites: UNetSites, p) -> Dict[str, torch.Tensor]:
    """The packed weights and tiled biases of every packed site, from the
    U-Net params ``p`` (by name), each differentiable in them: the
    entries' ``w4``, the packed convs' ``w2``, the duals' ``w2a`` /
    ``w2b`` (the skip's and the up's halves of the concat weight), the
    upconvs' ``wm`` [C, 4O] and each one's ``b4`` [4O]."""
    out = {}
    for name in sites.entry:
        out[f"{name}/w4"] = pack_conv3_weight_s2_t(p[f"{name}/w"])
    for name in sites.packed:
        out[f"{name}/w2"] = pack_conv3_weight_t(p[f"{name}/w"])
    for name in sites.dual:
        w = p[f"{name}/w"]
        ci = w.shape[2] // 2  # input = concat(skip C, up C)
        out[f"{name}/w2a"] = pack_conv3_weight_t(w[:, :, :ci])
        out[f"{name}/w2b"] = pack_conv3_weight_t(w[:, :, ci:])
    for name in sites.ups:
        w = p[f"{name}/w"]
        c, o = w.shape[2], w.shape[3]
        out[f"{name}/wm"] = w.permute(2, 0, 1, 3).reshape(c, 4 * o)
    for name in sites.packed_sites:
        out[f"{name}/b4"] = tile_bias4(p[f"{name}/b"])
    return out


def _host_f32(v) -> torch.Tensor:
    """A weight (tensor or array) as an f32 tensor on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


class _Pool4Select(torch.autograd.Function):
    """2×2/2 max pool of a flat packed tensor (the max over its 4 slots)
    that saves only the winning slot's int8 index: the first slot that
    attains the max (strict >), so that tied post-ReLU zeros send their
    grad where the JAX package's pool4_select does (conv_flat.pool_select,
    train_glue.pool_scatter; the train route runs both fused into H1 and
    train_glue's pool mode)."""

    @staticmethod
    def forward(ctx, x4):
        y, idx = pool_select(x4)
        ctx.save_for_backward(idx)
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return pool_scatter(g, idx)


def pool4_select(x4: torch.Tensor) -> torch.Tensor:
    """[N, hp, wp, 4C] → [N, hp, wp, C], the argmax-index pool
    (segmentation_tpu.models.unet_fast.pool4_select). No route calls it:
    the train route pools in conv2x2_pool_t (H1's pool index, or its plain
    version on the CPU); it stays as the tests' reference."""
    return _Pool4Select.apply(x4)


def tile_bias4(b: torch.Tensor) -> torch.Tensor:
    """[O] → [4O] slot-major flat bias."""
    return b.repeat(4)


def std_crop_offset(skip: torch.Tensor, h: torch.Tensor):
    """The origin (oh, ow) of the center crop of a std level's skip [N, Hs,
    Ws, C] to h's [N, H, W, .]: ((Hs - H) // 2, (Ws - W) // 2)."""
    return ((skip.shape[1] - h.shape[1]) // 2,
            (skip.shape[2] - h.shape[2]) // 2)


def std_crop(skip: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The center crop of a std level's skip to h's grid (a view)."""
    oh, ow = std_crop_offset(skip, h)
    return skip[:, oh : oh + h.shape[1], ow : ow + h.shape[2]]


def head_diff(output_w: torch.Tensor, output_b: torch.Tensor):
    """Block-diagonal per-slot difference head for n_classes = 2:
    wd [4C, 4], bd [4] with mask = (y_flat @ wd + bd > 0), the argmax of
    the 1×1 head on the packed decoder output (f32)."""
    w = output_w[0, 0].float()  # [C, 2]
    bv = output_b.float()
    c = w.shape[0]
    wd = torch.zeros((4 * c, 4), dtype=torch.float32, device=w.device)
    for s in range(4):
        wd[s * c : (s + 1) * c, s] = w[:, 1] - w[:, 0]
    bd = torch.full((4,), float(bv[1] - bv[0]), dtype=torch.float32,
                    device=w.device)
    return wd, bd


@dataclasses.dataclass
class UNetS2DInference:
    """Inference over standard UNet params in the packed layout. Needs an
    even input H/W (512 qualifies).

    ``padflat`` names the JAX class's two routes
    (segmentation_tpu/models/unet_fast.py:902): its padded-flat route
    (True, the default) and its 4-D route (False). In bf16 both compute
    one function, which the port computes on plain NHWC either way
    (tests/test_torch_int8_routes.py holds both values against the JAX
    4-D route). The int8 subclass computes the two routes' different int8
    functions."""

    cfg: ModelConfig
    levels: int = 4
    ops: Ops = KERNEL_OPS
    padflat: bool = True

    @property
    def packed_levels(self) -> int:
        return min(2, self.levels)

    def __post_init__(self):
        if self.levels < 1:
            raise ValueError("the s2d U-Net needs at least one level")
        self.sites = unet_sites(self.levels, self.packed_levels)

    # ---- weight preparation ---------------------------------------------
    def _host_packed(self, params) -> Dict[str, torch.Tensor]:
        """The params as f32 host tensors, with the packed sites' packed
        weights and tiled biases (``pack_sites``)."""
        host = {name: _host_f32(v) for name, v in params.items()}
        with torch.no_grad():
            host.update(pack_sites(self.sites, host))
        return host

    def _put(self, host, dtype, device) -> Dict[str, torch.Tensor]:
        """``_host_packed``'s dict on ``device``: every weight in
        ``dtype``, the packed sites' ``b4`` and the std convs' biases f32
        (the kernels' operand types), and the two-class mask head."""
        f32 = {f"{name}/b4" for name in self.sites.packed_sites}
        f32.update(f"{name}/b" for name in self.sites.std)
        out = {name: v.to(device=device,
                          dtype=torch.float32 if name in f32 else dtype)
               for name, v in host.items()}
        if self.cfg.n_classes == 2:
            wd, bd = head_diff(host["output/w"].to(device),
                               host["output/b"].to(device))
            out["head/wd"] = wd.to(torch.bfloat16)  # the kernel's operand
            out["head/bd"] = bd
        return out

    def prepare(self, params: Dict[str, torch.Tensor],
                dtype: torch.dtype = torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
        """Pack the packed-site weights once on the host (``pack_sites``),
        cast every weight to ``dtype``, tile the packed sites' biases to
        [4O] f32 and keep the std convs' biases f32 (the kernels' operand
        types). Runs in the span ``setup:prepare``."""
        with trace.span("setup:prepare"):
            return self._put(self._host_packed(params), dtype, device)

    # ---- conv-site hooks (models/unet_int8.py overrides them) -----------
    def _encode_packed(self, p, lvl, h):
        """Packed encoder level ``lvl``: (skip, pooled). The int8 subclass
        runs level 1 unfused through these two hooks too: conv1_1 in bf16
        (its ``_strided``), quantized and convolved in s8 by its
        ``_conv_pool``."""
        c1, c2 = self.sites.encoder[lvl]
        with trace.span("fwd", c1):
            h4 = self._strided(p, c1, h)
        with trace.span("fwd", c2):
            return self._conv_pool(p, c2, h4)

    def _strided(self, p, name, h):
        return self.ops.strided_conv4x4s2(h, p[f"{name}/w4"], p[f"{name}/b4"])

    def _conv_pool(self, p, name, h4):
        return self.ops.packed_conv2x2(h4, p[f"{name}/w2"], p[f"{name}/b4"],
                                       pool=True)

    def _packed_conv(self, p, name, h4):
        return self.ops.packed_conv2x2(h4, p[f"{name}/w2"], p[f"{name}/b4"])

    def _head_conv(self, p, name, h4):
        return self.ops.packed_conv2x2(
            h4, p[f"{name}/w2"], p[f"{name}/b4"],
            head=(p["head/wd"], p["head/bd"]), head_only=True,
        )

    def _deconv(self, p, up, h, scatter):
        return self.ops.rows_matmul(h.contiguous(), p[f"{up}/wm"],
                                    p[f"{up}/b4"], scatter=scatter)

    def _dual(self, p, name, skip, h4, offset):
        return self.ops.packed_conv2x2_dual(
            skip, h4, p[f"{name}/w2a"], p[f"{name}/w2b"], p[f"{name}/b4"],
            offset=offset,
        )

    def _std_conv(self, p, name, h):
        return self.ops.std_conv3x3(h, p[f"{name}/w"], p[f"{name}/b"])

    def _std_dual_conv(self, p, name, skip, h):
        # concat-free: conv(concat(sk, h), w) = conv(sk, w[:C]) +
        # conv(h, w[C:]), sk the crop of skip, read in place by the kernel
        w, ci = p[f"{name}/w"], skip.shape[-1]
        return self.ops.std_conv3x3_dual(
            skip, h, w[:, :, :ci], w[:, :, ci:], p[f"{name}/b"],
            offset=std_crop_offset(skip, h))

    def _pool(self, h):
        return max_pool(h, 2)

    def _std_deconv(self, p, up, h):
        return conv2d_transpose(h, p[f"{up}/w"], p[f"{up}/b"], 2)

    def _logits(self, p, h4):
        # 1×1 head IN packed layout (it commutes with the unpack)
        w1 = p["output/w"][0, 0].to(h4.dtype)
        logits = unpack2(view5(h4, self.cfg.n_kernels) @ w1)
        return logits + p["output/b"].to(logits.dtype)

    # ---- forward ----------------------------------------------------------
    def apply(self, p: Dict[str, torch.Tensor], x: torch.Tensor,
              packed_out: bool = False, head: bool = False):
        """x [N, H, W, C] → logits [N, h, w, n_classes]. ``packed_out``
        returns the last decoder tensor still packed, [N, hp, wp, 4k];
        ``head`` (n_classes = 2) returns only the fused u8 packed mask
        [N, hp, wp, 4] of the last conv."""
        L, pl_ = self.levels, self.packed_levels
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(
                f"space-to-depth U-Net needs even H/W, got "
                f"{x.shape[1]}x{x.shape[2]}; use models.unet.UNet"
            )

        # ---- encoder: packed levels ------------------------------------
        skips, h = [], x
        for lvl in range(pl_):
            skip, h = self._encode_packed(p, lvl, h)
            skips.append(skip)

        # ---- encoder: standard levels + bottleneck ---------------------
        span = trace.span
        for lvl in range(pl_, L + 1):
            for name in self.sites.encoder[lvl]:
                with span("fwd", name):
                    h = self._std_conv(p, name, h)
            if lvl < L:
                skips.append(h)
                with span("fwd", "std_pool"):
                    h = self._pool(h)

        # ---- decoder -----------------------------------------------------
        packed = False
        for lvl, up, c1, c2 in self.sites.decoder:
            skip = skips[lvl]
            if lvl < pl_:
                with span("fwd", up):
                    h4 = self._deconv(p, up, h, scatter=packed)
                # center-crop offset in UNPACKED units
                off = (skip.shape[1] - h4.shape[1],
                       skip.shape[2] - h4.shape[2])
                with span("fwd", c1):
                    h4 = self._dual(p, c1, skip, h4, off)
                if head and lvl == 0:
                    with span("fwd", c2, "+head"):
                        return self._head_conv(p, c2, h4)
                with span("fwd", c2):
                    h = self._packed_conv(p, c2, h4)
                packed = True
            else:
                with span("fwd", up):
                    h = self._std_deconv(p, up, h)
                with span("fwd", c1):
                    h = self._std_dual_conv(p, c1, skip, h)
                with span("fwd", c2):
                    h = self._std_conv(p, c2, h)

        if packed_out:
            return h
        with span("fwd", "head"):
            return self._logits(p, h)

    def apply_argmax(self, p: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
        """Class map [N, h, w] u8, identical to argmax(apply(...), -1) up to
        ties. For n_classes = 2 the head and argmax fold into the last
        packed conv (H1 ``head_only``); only the u8 mask is unpacked."""
        if self.cfg.n_classes == 2:
            mask_p = self.apply(p, x, head=True)
        else:
            hp = view5(self.apply(p, x, packed_out=True), self.cfg.n_kernels)
            with trace.span("fwd", "head"):
                w = p["output/w"][0, 0].to(hp.dtype)
                logits_p = hp @ w + p["output/b"].to(hp.dtype)
                mask_p = torch.argmax(logits_p, dim=-1).to(torch.uint8)
        with trace.span("fwd", "unpack"):
            n, hp_, wp_, _ = mask_p.shape
            m = mask_p.reshape(n, hp_, wp_, 2, 2).permute(0, 1, 3, 2, 4)
            return m.reshape(n, 2 * hp_, 2 * wp_)

    def output_hw(self, in_hw):
        return unet_output_hw(in_hw, self.levels)


@dataclasses.dataclass
class UNetS2DTrain(UNetS2DInference):
    """The train route's hooks (the JAX UNetS2DInference with
    pallas_vjp=True, pool_select_vjp=True, allow_pallas=False): every
    packed site runs its autograd.Function over ``ops``, with no shape
    gate: on CUDA tensors the kernels, whose wrappers raise for a shape
    they do not take; on CPU tensors their plain versions. The image entry
    (conv1_1, C = 3) is H3's gathered mode, bias and ReLU fused (the JAX
    package leaves it to XLA); each level's conv and pool are one H1 launch
    (conv2x2_pool_t), and each dual site reads its skip uncropped through
    the crop offset, as H2 does in serving. The standard levels' 3×3 convs
    run H8's bf16 mode as serving does, under std_conv3x3_t and
    std_conv3x3_dual_t (the dual's skip read at its crop origin), whose
    backward masks and sums the bias grad in one glue pass and leaves the
    dgrad and wgrad to cuDNN; upconv1–2 and the std pool keep autograd.

    The Functions' backward passes run their parts in the spans
    ``bwd:<site>/<part>`` (nn/kernels/train.py), beside the forward's
    ``fwd:<site>`` that ``apply`` opens."""

    def _conv_pool(self, p, name, h4):
        return kt.conv2x2_pool_t(h4, p[f"{name}/w2"], p[f"{name}/b4"],
                                 ops=self.ops, site=name)

    def _strided(self, p, name, h):
        return kt.conv4x4s2_t(h, p[f"{name}/w4"], p[f"{name}/b4"],
                              ops=self.ops, site=name)

    def _packed_conv(self, p, name, h4):
        return kt.conv2x2_t(h4, p[f"{name}/w2"], p[f"{name}/b4"],
                            ops=self.ops, site=name)

    def _deconv(self, p, up, h, scatter):
        f = kt.deconv_packed_t if scatter else kt.matmul_rows_t
        return f(h, p[f"{up}/wm"], p[f"{up}/b4"], ops=self.ops, site=up)

    def _dual(self, p, name, skip, h4, offset):
        return kt.conv2x2_dual_t(skip, h4, p[f"{name}/w2a"],
                                 p[f"{name}/w2b"], p[f"{name}/b4"],
                                 offset=offset, ops=self.ops, site=name)

    def _std_conv(self, p, name, h):
        return kt.std_conv3x3_t(h, p[f"{name}/w"], p[f"{name}/b"],
                                ops=self.ops, site=name)

    def _std_dual_conv(self, p, name, skip, h):
        return kt.std_conv3x3_dual_t(skip, h, p[f"{name}/w"], p[f"{name}/b"],
                                     offset=std_crop_offset(skip, h),
                                     ops=self.ops, site=name)


class UNetS2D(nn.Module):
    """Trainable space-to-depth U-Net (segmentation_tpu.models.unet_fast.
    UNetS2D): the U-Net's params under its names and HWIO shapes (so
    checkpoints interchange with models.unet.UNet and the JAX package),
    and a packed forward. Needs an even input H/W.

    ``ops``: the hand kernels by default; ``PLAIN_OPS`` runs the same step
    on their plain versions."""

    IN_OUT_CROP = True
    model_name = "unet"  # checkpoint-compatible with the standard U-Net

    def __init__(self, cfg: ModelConfig, levels: int = 4,
                 params: Dict[str, torch.Tensor] = None, seed: int = 0,
                 ops: Ops = KERNEL_OPS):
        super().__init__()
        self.cfg, self.levels = cfg, levels
        if params is None:
            params = init_params(cfg, generator(seed), levels)
        names = [n for n, _ in unet_param_shapes(cfg, levels)]
        if set(params) != set(names):
            raise ValueError("params do not match the U-Net's names")
        self.params = nn.ParameterDict({
            n: nn.Parameter(torch.as_tensor(params[n], dtype=torch.float32))
            for n in names})
        self.net = UNetS2DTrain(cfg, levels, ops=ops)

    def output_hw(self, in_hw):
        return unet_output_hw(in_hw, self.levels)

    def param_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.params.items()}

    def packed(self) -> Dict[str, torch.Tensor]:
        """The params plus the packed weights and tiled biases of the
        packed sites, every one differentiable in the params."""
        p = dict(self.params.items())
        p.update(pack_sites(self.net.sites, p))
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, C] in the compute dtype → logits [N, h, w,
        n_classes]."""
        with trace.span("fwd", "pack_weights"):
            p = self.packed()
        return self.net.apply(p, x)
