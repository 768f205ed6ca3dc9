"""Calibrated int8 U-Net serving (segmentation_tpu.models.unet_int8).

Every 3×3 conv site of the space-to-depth U-Net runs int8 with static
symmetric per-output-channel weight scales and static per-site activation
scales calibrated on sample batches; the packed-decoder deconvs run int8
too (``quant_deconvs``). Activations stay int8-RESIDENT between sites:
each site's epilogue requantizes its output at its consumer's calibrated
input scale, so no bf16 intermediate and no quantize pass exist between
them. The std deconvs and the 1×1 head stay bf16.

The JAX class has two routes, which compute different int8 functions; the
port computes each on plain NHWC tensors. ``padflat=True`` (the default)
is the padded-flat route (_apply_padflat with the UNetS2DInt8 hooks):

  level 1         H5 entry_chain: bf16 conv1_1 requantized in shared
                  memory, s8 conv1_2, slot-max pool — one launch; where
                  the JAX route's fusion gate declines (``_fused_level1``)
                  the unfused level 1 below
  level 2         H3 s8 conv2_1, H1 s8 conv2_2 + pool
  levels 3–5      H8 int8_conv (s8 3×3 conv, fused requant epilogue; the
                  encoder pool runs on the codes), conv5_2 emits bf16
  std decoder     bf16 deconv, H8 int8_std_dual_conv (the skip's crop
                  folded into its loads, the bf16 up side quantized by
                  the division as it is gathered), H8 int8_conv (conv6_2
                  emits bf16, conv7_2 s8 at upconv3's scale)
  packed decoder  H4 s8 upconv3/upconv4, H2 s8 duals, H1 s8 conv8_2 and
                  conv9_2 (bf16 value + mask head, or bf16 logits path)

``padflat=False`` is the 4-D route (UNetS2DInference.apply with the int8
hooks, segmentation_tpu/models/unet_int8.py:415-616, :913-925):

  level 1         conv1_1 in bf16 (H3, C = 3), its output quantized at
                  conv1_2's scale by a plain op (JAX: in XLA), H1 s8
                  conv1_2 + pool
  packed decoder  the deconvs in bf16 (H4) on their dequantized s8 inputs;
                  each dual (H2 s8) quantizes its bf16 up side inline
                  (act_scale_b), the skip crop folded into its loads

and the rest as above. ``quant_deconvs=False`` keeps the padded-flat route
with bf16 packed-decoder deconvs: conv7_2 and conv8_2 emit bf16, H4 runs
in bf16 and both duals quantize their up side inline.

Without calibrated scales every hook falls through to the bf16 forward of
UNetS2DInference, as the JAX class does.

    q = UNetS2DInt8(cfg)                       # or padflat=False, or
    prepared = q.prepare(params, calib_batches=[x0], device="cuda")
    masks = q.apply_argmax(prepared, x)        # quant_deconvs=False
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from segmentation_tpu_torch.models.unet import unet_param_shapes
from segmentation_tpu_torch.models.unet_fast import (
    UNetS2DInference,
    std_crop,
    std_crop_offset,
)
from segmentation_tpu_torch.nn.kernels import conv_int8
from segmentation_tpu_torch.nn.kernels.conv_int8 import (
    Int8Ops,
    k_major,
    quant_act,
    std_affine,
    std_conv3x3_dual_s8,
    std_conv3x3_s8,
    std_dual_scales,
    strided_k_major,
)
from segmentation_tpu_torch.nn.packing import crop_packed
from segmentation_tpu_torch.utils import trace

S8, BF16 = torch.int8, torch.bfloat16
_PLANNED = "conv1_1/qmul"  # written by UNetS2DInt8.plan


# ------------------------------------------------------------ quantization
def quantize_weight(w: np.ndarray):
    """A weight [..., O] (a conv's [kh, kw, CI, CO], the deconv's packed wm
    [C, 4O]) → (int8 weights, per-O float32 scales): max|w| / 127 over
    every other axis, floored at 1e-8, round half to even, clip to ±127."""
    w = np.asarray(w, np.float32)
    s = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
    s = np.maximum(s, 1e-8)
    wq = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return wq, s.astype(np.float32)


def int8_conv(x, wq, w_scale, act_scale: float, b,
              out_scale: Optional[float] = None, conv=std_conv3x3_s8,
              wk=None, affine=None):
    """Standard-layout int8 3×3 VALID conv with a float rescale epilogue
    and ReLU (as every site of the model). ``x`` s8 (resident, stored at
    ``act_scale``) or float (quantized here, ``quant_act``). With
    ``out_scale`` the site requantizes (round half to even, ±127 clip) and
    emits s8; else it emits bf16. ``conv`` is H8 (conv_int8.std_conv3x3_s8)
    or its plain version, run on the epilogue's vectors ``affine`` = (mul,
    add) (``std_affine`` on the host where not given; UNetS2DInt8.plan
    makes them once) with the K-major copy ``wk`` of wq."""
    xq = x if x.dtype == S8 else quant_act(x, act_scale)
    if affine is None:
        affine = [v.to(x.device)
                  for v in std_affine(w_scale, act_scale, b, out_scale)]
    return conv(xq, wq, *affine, requant=out_scale is not None, wk=wk)


def int8_std_dual_conv(sk, up, wqa, wsa, sk_scale: float, wqb, wsb,
                       asb: float, b, out_scale: Optional[float] = None,
                       conv=std_conv3x3_dual_s8, offset=(0, 0), wka=None,
                       wkb=None, cs=None):
    """Decoder std conv with the concat weight split per operand (skip
    half at the skip's stored scale, upsampled half quantized at ``asb``),
    with ReLU; the skip cropped at ``offset`` (its origin) to up's grid.
    The skip-side partial is rounded to bf16 before the sum, as the JAX
    function does. ``conv`` is H8's dual (conv_int8.std_conv3x3_dual_s8)
    or its plain version, on the sides' scales ``cs`` = (cs_a, cs_b)
    (``std_dual_scales`` on the host where not given) and the K-major
    copies ``wka``, ``wkb``."""
    if cs is None:
        cs = [v.to(up.device)
              for v in std_dual_scales(wsa, sk_scale, wsb, asb)]
    return conv(sk, up, wqa, wqb, *cs, b.float(), out_scale=out_scale,
                offset=offset,
                act_scale_a=None if sk.dtype == S8 else sk_scale,
                act_scale_b=None if up.dtype == S8 else asb, wka=wka,
                wkb=wkb)


def _affine(cs: torch.Tensor, b4: torch.Tensor, out_s: Optional[float]):
    """(mul, add) of a site's epilogue relu(acc · mul + add): the dequant
    scale and bias, folded with 1/out_scale at a requantizing site, in the
    f32 products of nn/pallas/conv.py _epilogue_parts."""
    if out_s is None:
        return cs.contiguous(), b4.contiguous()
    oi = float(np.float32(1.0 / out_s))
    return cs * oi, b4 * oi


# ------------------------------------------------------------------- model
@dataclasses.dataclass
class UNetS2DInt8(UNetS2DInference):
    """Quantized UNetS2DInference: the int8 sites run through ``ops8``
    (the hand kernels by default, their plain versions with
    conv_int8.PLAIN_OPS); calibration runs the bf16 forward of ``ops``.
    ``padflat`` picks the JAX route whose function it computes (see the
    module docstring)."""

    ops8: Int8Ops = conv_int8.KERNEL_OPS
    # int8 packed-decoder deconvs (segmentation_tpu/models/unet_int8.py:
    # 199-215); False keeps them bf16: no deconv site is quantized,
    # calibrated or in the scale graph
    quant_deconvs: bool = True

    _calibrating = None  # {site: running max|x|} during calibration

    # ---- weights and calibration ----------------------------------------
    def prepare(self, params: Dict[str, torch.Tensor],
                calib_batches: Sequence[torch.Tensor] = (),
                dtype: torch.dtype = torch.bfloat16,
                device=None) -> Dict[str, torch.Tensor]:
        """The bf16 prepare, plus the int8 weights (quantized from its f32
        packed weights, per 4O column) and, given calibration batches, the
        activation scales ``ascale`` / ``ascale_a`` / ``ascale_b`` (0-d
        f32 host tensors) of every site and the kernels' epilogue vectors.
        Without calibration batches no activation scale exists and the
        forward is the bf16 one. The weights' part runs in the span
        ``setup:prepare``, the calibration in ``setup:calibrate``."""
        s = self.sites
        with trace.span("setup:prepare"):
            host = self._host_packed(params)
            prepared = self._put(host, dtype, device)

            def put(name, wq_key, ws_key, w):
                for k, v in zip((wq_key, ws_key), quantize_weight(w.numpy())):
                    prepared[f"{name}/{k}"] = torch.as_tensor(v).to(device)

            for name in s.entry:
                put(name, "wq4", "wscale4", host[f"{name}/w4"])
            for name in s.packed:
                put(name, "wq", "wscale", host[f"{name}/w2"])
            for name in s.dual:
                put(name, "wq_a", "wscale_a", host[f"{name}/w2a"])
                put(name, "wq_b", "wscale_b", host[f"{name}/w2b"])
            for name in s.std:
                put(name, "wq", "wscale", host[f"{name}/w"])
            for name in s.std_dual:
                w = host[f"{name}/w"]
                ca = w.shape[2] - w.shape[3]
                if ca != w.shape[3]:
                    raise ValueError(f"{name}: concat width {w.shape}")
                put(name, "wq_a", "wscale_a", w[:, :, :ca])
                put(name, "wq_b", "wscale_b", w[:, :, ca:])
            for name in self._int8_ups:
                put(name, "wqm", "wscale", host[f"{name}/wm"])
            for name in params:  # the int8 epilogues add f32 biases
                if name.endswith("/b"):
                    prepared[name] = host[name].to(device)
        if len(calib_batches):
            self._calibrate(prepared, calib_batches, dtype)
        return prepared

    def _calibrate(self, p, calib_batches, dtype) -> None:
        """Run the bf16 forward on each batch, record max|x| at every
        quantized site's input (the a and b sides of the duals, the a side
        on the cropped skip) and store ascale = max(absmax, 1e-6) / 127;
        then ``plan``. Runs in the span ``setup:calibrate``."""
        with trace.span("setup:calibrate"):
            self._calibrate_scales(p, calib_batches, dtype)
            self.plan(p)

    def _calibrate_scales(self, p, calib_batches, dtype) -> None:
        s = self.sites
        self._calibrating = {}
        try:
            dev = p["conv1_1/w4"].device
            with torch.no_grad():
                for x in calib_batches:
                    self.apply(p, torch.as_tensor(x).to(dev, dtype))
            rec = {k: float(v) for k, v in self._calibrating.items()}
        finally:
            self._calibrating = None

        def scale(site):
            return torch.tensor(
                np.float32(max(rec.get(site, 0.0), 1e-6) / 127.0))

        for name in s.entry + s.packed + s.std + self._int8_ups:
            if name not in s.std_dual:
                p[f"{name}/ascale"] = scale(name)
        for name in s.dual + s.std_dual:  # a: the cropped skip, b: the up
            p[f"{name}/ascale_a"] = scale(name)
            p[f"{name}/ascale_b"] = scale(f"{name}@b")

    def _record(self, name, x):
        m = x.detach().abs().amax().float()
        prev = self._calibrating.get(name)
        self._calibrating[name] = m if prev is None else torch.maximum(prev,
                                                                       m)

    # ---- the int8-resident scale graph -----------------------------------
    def __post_init__(self):
        super().__post_init__()
        s = self.sites
        shapes = dict(unet_param_shapes(self.cfg, self.levels))
        wide = max(4 * shapes[f"{n}/w"][-1] for n in s.entry + s.packed
                   + s.dual)
        if wide > max(conv_int8.O4_S8):
            raise ValueError(
                f"UNetS2DInt8: n_kernels {self.cfg.n_kernels} puts 4O = "
                f"{wide} at a packed site; the s8 modes of H1-H4 "
                f"(packed_conv2x2_s8, packed_conv2x2_dual_s8, "
                f"strided_conv4x4s2_s8, rows_matmul_s8) take 4O = "
                f"{' or '.join(map(str, conv_int8.O4_S8))} only: serve this "
                f"width with UNetS2DInference (bf16)")
        # the packed-level upconvs that run int8: none without quant_deconvs
        self._int8_ups = s.ups if self.quant_deconvs else ()
        # {site: the scale key its OUTPUT is stored at}: its consumer's
        # calibrated input scale (an upconv's, its dual's b side), where
        # both run int8; a site missing here emits bf16, as the bottleneck
        # does in the JAX graph (an int8 upconv follows it at levels = 1)
        int8 = set(s.entry + s.packed + s.dual + s.std + self._int8_ups)
        self._out_keys = {
            site: f"{nxt}/ascale_b" if site in s.ups else f"{nxt}/ascale"
            for site, nxt in s.consumer.items()
            if site in int8 and nxt in int8 and site != s.encoder[-1][1]}

    def _out_scale_of(self, p, name) -> Optional[float]:
        key = self._out_keys.get(name)
        return None if key is None or key not in p else float(p[key])

    def _in_scale_of(self, p, name, side=None) -> float:
        return float(p[f"{name}/ascale" + (f"_{side}" if side else "")])

    def _skip_scale_of(self, p, name) -> float:
        """Scale of the resident skip feeding decoder conv ``name``: the
        encoder conv's OUT scale (the next level's), not the crop-local
        ascale_a."""
        return self._out_scale_of(p, self.sites.skip[name])

    def plan(self, p) -> Dict[str, torch.Tensor]:
        """Add the hand-kernel sites' epilogue vectors to a calibrated
        ``p`` and return it: ``qmul``/``qadd`` (and the duals'
        ``qcs_a``/``qcs_b``), computed once from the activation scales, and
        the K-major copies of the s8 weights that s8 wgmma reads (H1's and
        H5's conv1_2 ``wk`` and H2's ``wk_a``/``wk_b``: conv_int8.k_major;
        H3's ``wk4``: conv_int8.strided_k_major; made here once, never per
        request). The int8 route runs on a planned dict only
        (``_PLANNED`` in it). The std levels' H8 sites get theirs too:
        ``wk`` (the duals' ``wk_a``/``wk_b``), ``qmul``/``qadd``
        (``std_affine``) and the duals' ``qcs_a``/``qcs_b`` for the
        resident skip (``std_dual_scales``), each computed in f32 on the
        host, then moved to the weights' device. Runs in the span
        ``setup:plan``."""
        with trace.span("setup:plan"):
            return self._plan(p)

    def _plan(self, p) -> Dict[str, torch.Tensor]:
        s = self.sites
        q = {}
        for name in s.std:
            if name in s.std_dual:
                for side in "ab":
                    q[f"{name}/wk_{side}"] = k_major(p[f"{name}/wq_{side}"])
                vecs = std_dual_scales(
                    p[f"{name}/wscale_a"], self._skip_scale_of(p, name),
                    p[f"{name}/wscale_b"], self._in_scale_of(p, name, "b"))
                keys = (f"{name}/qcs_a", f"{name}/qcs_b")
            else:
                q[f"{name}/wk"] = k_major(p[f"{name}/wq"])
                vecs = std_affine(p[f"{name}/wscale"],
                                  self._in_scale_of(p, name), p[f"{name}/b"],
                                  self._out_scale_of(p, name))
                keys = (f"{name}/qmul", f"{name}/qadd")
            dev = p[f"{name}/wq"].device
            q.update(zip(keys, (v.to(dev) for v in vecs)))
        for name in s.packed:
            q[f"{name}/wk"] = k_major(p[f"{name}/wq"])
        for name in s.entry[1:]:
            q[f"{name}/wk4"] = strided_k_major(p[f"{name}/wq4"])
        for name in s.dual:
            for side in "ab":
                q[f"{name}/wk_{side}"] = k_major(p[f"{name}/wq_{side}"])
        c1 = s.entry[0]  # H5's conv1_1: requant at conv1_2's scale, no cs
        b4 = p[f"{c1}/b4"]
        q[f"{c1}/qmul"], q[f"{c1}/qadd"] = _affine(
            torch.ones_like(b4), b4, self._out_scale_of(p, c1))
        for name in self._int8_ups:
            q[f"{name}/wkm"] = k_major(p[f"{name}/wqm"])
        for name in s.entry[1:] + s.packed + self._int8_ups:
            ws = p[f"{name}/wscale4" if name in s.entry
                   else f"{name}/wscale"]
            q[f"{name}/qmul"], q[f"{name}/qadd"] = _affine(
                ws * self._in_scale_of(p, name), p[f"{name}/b4"],
                self._out_scale_of(p, name))
        for name in s.dual:
            q[f"{name}/qcs_a"] = (p[f"{name}/wscale_a"]
                                  * self._skip_scale_of(p, name))
            q[f"{name}/qcs_b"] = (p[f"{name}/wscale_b"]
                                  * self._in_scale_of(p, name, "b"))
            b4 = p[f"{name}/b4"]
            q[f"{name}/qmul"], q[f"{name}/qadd"] = _affine(
                torch.ones_like(b4), b4, self._out_scale_of(p, name))
        p.update(q)  # all at once: a failed plan leaves p unplanned
        return p

    def _q(self, p) -> bool:
        """Run the int8 route: ``p`` was calibrated and planned."""
        return _PLANNED in p

    def _fused_level1(self, x) -> bool:
        """The JAX padded-flat route fuses level 1 (entry_chain_pf2, here
        H5) where its paired-column layout and its pair-major entry take
        the input: _pf2_ok (segmentation_tpu/models/unet_fast.py:1296)
        with the int8 tile 32 and _pf_entry_chain's W % 4 == 0, (W // 4) %
        32 == 0 (segmentation_tpu/models/unet_int8.py:667-681), which
        hold together iff H % 4 == 0 and W % 128 == 0. Elsewhere, and on
        the 4-D route, level 1 is unfused: conv1_1 in bf16, quantized,
        then conv1_2 in s8 — another function (conv1_1 rounds to bf16 and
        quantizes by a division)."""
        return (self.padflat and self.packed_levels >= 2
                and x.shape[1] % 4 == 0 and x.shape[2] % 128 == 0)

    # ---- hook overrides --------------------------------------------------
    def _encode_packed(self, p, lvl, h):
        if lvl == 0 and self._q(p) and self._fused_level1(h):
            c1, c2 = self.sites.encoder[0]
            with trace.span("fwd", "conv1_1+conv1_2"):
                return self.ops8.entry_chain(
                    h, p[f"{c1}/w4"], p[f"{c1}/qmul"], p[f"{c1}/qadd"],
                    p[f"{c2}/wq"], p[f"{c2}/qmul"], p[f"{c2}/qadd"],
                    wk=p[f"{c2}/wk"])
        return super()._encode_packed(p, lvl, h)

    def _strided(self, p, name, h):
        if self._calibrating is not None:
            self._record(name, h)
        if not self._q(p) or h.shape[-1] < 16:
            # the C = 3 image entry stays bf16, as in JAX (its int8
            # kernel needs C >= 16)
            return super()._strided(p, name, h)
        return self.ops8.strided_conv4x4s2(
            h, p[f"{name}/wq4"], p[f"{name}/qmul"], p[f"{name}/qadd"],
            wk4=p[f"{name}/wk4"])

    def _conv_pool(self, p, name, h4):
        if self._calibrating is not None:
            self._record(name, h4)
        if not self._q(p):
            return super()._conv_pool(p, name, h4)
        if h4.dtype != S8:
            # the bf16 image entry's output: quantized by a plain op at
            # this site's scale, as JAX does in XLA (_packed_conv_pool,
            # _pf_entry)
            h4 = quant_act(h4, self._in_scale_of(p, name))
        return self.ops8.packed_conv2x2(
            h4, p[f"{name}/wq"], p[f"{name}/qmul"], p[f"{name}/qadd"],
            requant=self._out_keys.get(name) in p, pool=True,
            wk=p[f"{name}/wk"])

    def _packed_conv(self, p, name, h4):
        if self._calibrating is not None:
            self._record(name, h4)
        if not self._q(p):
            return super()._packed_conv(p, name, h4)
        return self.ops8.packed_conv2x2(
            h4, p[f"{name}/wq"], p[f"{name}/qmul"], p[f"{name}/qadd"],
            requant=self._out_keys.get(name) in p, wk=p[f"{name}/wk"])

    def _head_conv(self, p, name, h4):
        if not self._q(p):
            return super()._head_conv(p, name, h4)
        return self.ops8.packed_conv2x2(
            h4, p[f"{name}/wq"], p[f"{name}/qmul"], p[f"{name}/qadd"],
            requant=False, head=(p["head/wd"], p["head/bd"]),
            head_only=True, wk=p[f"{name}/wk"])

    def _deconv(self, p, up, h, scatter):
        quantized = up in self._int8_ups
        if self._calibrating is not None and quantized:
            self._record(up, h)
        if not self._q(p):
            return super()._deconv(p, up, h, scatter)
        if quantized and self.padflat:
            return self.ops8.rows_matmul(h.contiguous(), p[f"{up}/wqm"],
                                         p[f"{up}/qmul"], p[f"{up}/qadd"],
                                         scatter=scatter,
                                         wkm=p[f"{up}/wkm"])
        if h.dtype == S8:
            # a resident input to a bf16 deconv, dequantized as JAX does
            # (h.astype(bf16) * in_s: the scale rounds to bf16 first)
            scale = torch.tensor(self._in_scale_of(p, up), dtype=BF16)
            h = h.to(BF16) * float(scale)
        return super()._deconv(p, up, h, scatter)

    def _dual(self, p, name, skip, h4, offset):
        if self._calibrating is not None:
            self._record(name, crop_packed(skip, h4.shape, offset))
            self._record(f"{name}@b", h4)
        if not self._q(p):
            return super()._dual(p, name, skip, h4, offset)
        # the skip is resident; a bf16 up side (a bf16 deconv's output) is
        # quantized as the kernel loads it, at the b side's scale
        act_b = None if h4.dtype == S8 else self._in_scale_of(p, name, "b")
        return self.ops8.packed_conv2x2_dual(
            skip, h4, p[f"{name}/wq_a"], p[f"{name}/wq_b"],
            p[f"{name}/qcs_a"], p[f"{name}/qcs_b"], p[f"{name}/qmul"],
            p[f"{name}/qadd"], offset=offset, act_scale_b=act_b,
            wka=p[f"{name}/wk_a"], wkb=p[f"{name}/wk_b"])

    def _std_conv(self, p, name, h):
        if self._calibrating is not None:
            self._record(name, h)
        if not self._q(p):
            return super()._std_conv(p, name, h)
        return int8_conv(h, p[f"{name}/wq"], p[f"{name}/wscale"],
                         self._in_scale_of(p, name), p[f"{name}/b"],
                         out_scale=self._out_scale_of(p, name),
                         conv=self.ops8.std_conv3x3, wk=p[f"{name}/wk"],
                         affine=(p[f"{name}/qmul"], p[f"{name}/qadd"]))

    def _std_dual_conv(self, p, name, skip, h):
        if self._calibrating is not None:
            self._record(name, std_crop(skip, h))
            self._record(f"{name}@b", h)
        if not self._q(p):
            return super()._std_dual_conv(p, name, skip, h)
        resident = skip.dtype == S8
        sk_s = (self._skip_scale_of(p, name) if resident
                else self._in_scale_of(p, name, "a"))
        return int8_std_dual_conv(
            skip, h, p[f"{name}/wq_a"], p[f"{name}/wscale_a"], sk_s,
            p[f"{name}/wq_b"], p[f"{name}/wscale_b"],
            self._in_scale_of(p, name, "b"), p[f"{name}/b"],
            out_scale=self._out_scale_of(p, name),
            conv=self.ops8.std_conv3x3_dual,
            offset=std_crop_offset(skip, h), wka=p[f"{name}/wk_a"],
            wkb=p[f"{name}/wk_b"],
            cs=(p[f"{name}/qcs_a"], p[f"{name}/qcs_b"]) if resident
            else None)

    def _pool(self, h):
        if h.dtype != S8:
            return super()._pool(h)
        n, hh, ww, c = h.shape  # VALID 2×2/2 on the codes
        h = h[:, : hh // 2 * 2, : ww // 2 * 2]
        return h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax((2, 4))
