"""Trainable conv sites (segmentation_tpu.nn.pallas.train).

Eight ``torch.autograd.Function``s over one ``Ops`` (the hand kernels
H1–H4, H6, H8's bf16 mode, H9 and the glue kernels of train_glue.py by
default, their plain versions with ``PLAIN_OPS``): six at the packed
sites, two at the standard levels' 3×3 convs. Each forward runs one op of
``ops`` and saves its input(s), the weight cast to the input's dtype, and
its output, as the JAX wrappers' save-output variant does. Each backward
masks the cotangent with y > 0 (every train site ends in a ReLU, and y > 0
exactly where the pre-activation is) and sums the bias gradient in one
pass (``ops.relu_bias_grad``), then:

  conv2x2_t        dx by H6, dw by H9, both reading the masked cotangent
                   in place in its zero-margined buffer
  conv2x2_pool_t   the level sites (conv1_2, conv2_2): H1 with the pool and
                   its index in one launch; the backward adds the pool's
                   gradient to the skip's in the mask's pass (JAX:
                   conv2x2_t, then pool4_select)
  conv2x2_dual_t   the uncropped skip and the crop offset, as H2 reads them
                   in serving (JAX: packed_center_crop_flat, then
                   conv2x2_dual_t); dskip and dup by H6's dual mode, dskip
                   written into the crop window of a skip-sized buffer whose
                   margin alone is zeroed; (dwa, dwb) by H9's dual mode
                   in one launch, the skip read in place through its
                   crop; db
  conv4x4s2_t      dx and dw plain (torch.nn.grad; XLA in the JAX package)
  matmul_rows_t    dx = g wmᵀ, dwm = xᵀ g
  deconv_packed_t  the same on the unpacked input, dx packed again
  std_conv3x3_t    the std levels' 3×3 conv, unpacked NHWC (H8 forward,
                   bias and ReLU fused; the JAX package leaves these convs
                   to XLA): dx and dw by cuDNN
                   (aten.convolution_backward) from the masked cotangent
                   in its channels-last layout, as stored
  std_conv3x3_dual_t  the std decoder's concat-free first conv, the skip
                   uncropped and read by H8 at its crop origin; dskip the
                   skip-side dgrad placed in the crop window of a
                   skip-sized zero gradient, dw the two sides' wgrads (the
                   skip's from a copy of its crop) joined as the concat
                   weight's

dx keeps the input's dtype and dw comes back in it too (bf16 in training,
as the JAX package's transpose of a bf16 conv); autograd casts dw to the
f32 parameter's grad. Only ``relu=True`` is taken: every train site has
it, and the kernels fuse it. The JAX package's recompute-mask variant
(``SEG_PALLAS_TRAIN=2``) is not ported.

Each backward part runs in the span ``bwd:<site>/<part>``
(utils/trace.py; the forward's ``fwd:<site>`` is the model's), which
profile_train.py reads to attribute the step's device time to call sites.
"""

from __future__ import annotations

import torch
from torch.autograd import Function

from segmentation_tpu_torch.nn.kernels.conv_flat import KERNEL_OPS
from segmentation_tpu_torch.nn.packing import pack2, unpack2, view5
from segmentation_tpu_torch.utils import trace


def _relu_only(relu: bool) -> None:
    if not relu:
        raise ValueError("the trainable packed sites take relu=True only")


def _cast(w, x):
    return w.to(x.dtype).contiguous()


def _flat_wgrad(x, g):
    """xᵀ g over every pixel: [C, 4O]."""
    return x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])


def _conv2x2_grads(ctx, x, w, gm, needs_dx):
    """dx (H6, reading gm's [N, h, w] window) and dw (H9) of a 2×2 site
    from the zero-margined masked cotangent gm [N, h+1, w+1, 4O]."""
    dx = None
    if needs_dx:
        with trace.span("bwd", ctx.site, "/dgrad"):
            dx = ctx.ops.packed_conv2x2_dgrad(gm[:, :-1, :-1], w)
    with trace.span("bwd", ctx.site, "/wgrad"):
        dw = ctx.ops.packed_conv2x2_wgrad(x, gm)
    return dx, dw


class _Conv2x2(Function):
    @staticmethod
    def forward(ctx, x, w, b4, ops, site):
        x, w = x.contiguous(), _cast(w, x)
        y = ops.packed_conv2x2(x, w, b4.float())
        ctx.save_for_backward(x, w, y)
        ctx.ops, ctx.site = ops, site
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        with trace.span("bwd", ctx.site, "/mask_bias"):
            gm, db = ctx.ops.relu_bias_grad(g.contiguous(), y, pad=True)
        dx, dw = _conv2x2_grads(ctx, x, w, gm, ctx.needs_input_grad[0])
        return dx, dw, db, None, None


class _Conv2x2Pool(Function):
    @staticmethod
    def forward(ctx, x, w, b4, ops, site):
        x, w = x.contiguous(), _cast(w, x)
        y, pooled, idx = ops.packed_conv2x2(x, w, b4.float(),
                                            pool_index=True)
        ctx.save_for_backward(x, w, y, idx)
        ctx.ops, ctx.site = ops, site
        ctx.set_materialize_grads(False)
        return y, pooled

    @staticmethod
    def backward(ctx, g, g_pool):
        x, w, y, idx = ctx.saved_tensors
        if g is None and g_pool is None:
            return None, None, None, None, None
        g = None if g is None else g.contiguous()
        pool = None if g_pool is None else (g_pool.contiguous(), idx)
        with trace.span("bwd", ctx.site, "/mask_bias"):
            gm, db = ctx.ops.relu_bias_grad(g, y, pool=pool, pad=True)
        dx, dw = _conv2x2_grads(ctx, x, w, gm, ctx.needs_input_grad[0])
        return dx, dw, db, None, None


class _Conv2x2Dual(Function):
    @staticmethod
    def forward(ctx, skip, up, wa, wb, b4, ops, site, offset):
        skip, up = skip.contiguous(), up.contiguous()
        wa, wb = _cast(wa, up), _cast(wb, up)
        y = ops.packed_conv2x2_dual(skip, up, wa, wb, b4.float(),
                                    offset=offset)
        ctx.save_for_backward(skip, up, wa, wb, y)
        ctx.ops, ctx.site, ctx.offset = ops, site, tuple(offset)
        return y

    @staticmethod
    def backward(ctx, g):
        skip, up, wa, wb, y = ctx.saved_tensors
        with trace.span("bwd", ctx.site, "/mask_bias"):
            gm, db = ctx.ops.relu_bias_grad(g.contiguous(), y, pad=True)
        with trace.span("bwd", ctx.site, "/dgrad"):
            dskip, dup = ctx.ops.packed_conv2x2_dgrad_dual(
                gm[:, :-1, :-1], wa, wb, skip_shape=tuple(skip.shape),
                offset=ctx.offset)
        with trace.span("bwd", ctx.site, "/wgrad"):
            dwa, dwb = ctx.ops.packed_conv2x2_wgrad_dual(
                skip, up, gm, offset=ctx.offset)
        return dskip, dup, dwa, dwb, db, None, None, None


class _Conv4x4s2(Function):
    @staticmethod
    def forward(ctx, x, w4, b4, ops, site):
        x, w4 = x.contiguous(), _cast(w4, x)
        y = ops.strided_conv4x4s2(x, w4, b4.float())
        ctx.save_for_backward(x, w4, y)
        ctx.ops, ctx.site = ops, site
        return y

    @staticmethod
    def backward(ctx, g):
        x, w4, y = ctx.saved_tensors
        with trace.span("bwd", ctx.site, "/mask_bias"):
            g, db = ctx.ops.relu_bias_grad(g.contiguous(), y)
        gn = g.permute(0, 3, 1, 2)
        xn, wn = x.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1)
        dx = None
        if ctx.needs_input_grad[0]:
            with trace.span("bwd", ctx.site, "/dgrad"):
                dx = torch.nn.grad.conv2d_input(xn.shape, wn, gn, stride=2)
                dx = dx.permute(0, 2, 3, 1).contiguous()
        with trace.span("bwd", ctx.site, "/wgrad"):
            dw = torch.nn.grad.conv2d_weight(xn, wn.shape, gn, stride=2)
        return dx, dw.permute(2, 3, 1, 0), db, None, None


class _MatmulRows(Function):
    @staticmethod
    def forward(ctx, x, wm, b4, ops, site):
        x, wm = x.contiguous(), _cast(wm, x)
        y = ops.rows_matmul(x, wm, b4.float(), scatter=False)
        ctx.save_for_backward(x, wm, y)
        ctx.ops, ctx.site = ops, site
        return y

    @staticmethod
    def backward(ctx, g):
        x, wm, y = ctx.saved_tensors
        with trace.span("bwd", ctx.site, "/mask_bias"):
            g, db = ctx.ops.relu_bias_grad(g.contiguous(), y)
        with trace.span("bwd", ctx.site, "/dgrad"):
            dx = g @ wm.T
        with trace.span("bwd", ctx.site, "/wgrad"):
            dw = _flat_wgrad(x, g)
        return dx, dw, db, None, None


class _DeconvPacked(Function):
    @staticmethod
    def forward(ctx, x4, wm, b4, ops, site):
        x4, wm = x4.contiguous(), _cast(wm, x4)
        y = ops.rows_matmul(x4, wm, b4.float(), scatter=True)
        ctx.save_for_backward(x4, wm, y)
        ctx.ops, ctx.site = ops, site
        return y

    @staticmethod
    def backward(ctx, g):
        x4, wm, y = ctx.saved_tensors
        with trace.span("bwd", ctx.site, "/mask_bias"):
            g, db = ctx.ops.relu_bias_grad(g.contiguous(), y)
        n, i, j, c4 = x4.shape
        with trace.span("bwd", ctx.site, "/dgrad"):
            dx = pack2(g @ wm.T).reshape(n, i, j, c4)
        with trace.span("bwd", ctx.site, "/wgrad"):
            xu = unpack2(view5(x4, c4 // 4))  # [N, 2i, 2j, C]
            dw = _flat_wgrad(xu, g)
        return dx, dw, db, None, None


# aten.convolution_backward's arguments of a VALID 3×3 conv after the
# tensors: bias sizes, stride, padding, dilation, transposed, output
# padding, groups
_CONV3X3 = (None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1)


def _nchw(t):
    """The NCHW view of an NHWC tensor (channels-last, no copy)."""
    return t.permute(0, 3, 1, 2)


def _oihw(w):
    """An HWIO weight as the channels-last OIHW tensor cuDNN reads (a copy
    of the weight, made once a backward)."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _std_dgrad(gn, xn, wn):
    """dx [N, H, W, C] of a VALID 3×3 conv from the masked cotangent gn
    (an NCHW view of the channels-last gm). ``xn`` gives dx's shape and
    layout (channels-last NCHW, so no layout copy is made); its values are
    not read."""
    dx = torch.ops.aten.convolution_backward(
        gn, xn, wn, *_CONV3X3, [True, False, False])[0]
    return dx.permute(0, 2, 3, 1).contiguous()


def _std_wgrad(gn, xn, wn):
    """dw [3, 3, C, O] (HWIO) of a VALID 3×3 conv."""
    dw = torch.ops.aten.convolution_backward(
        gn, xn, wn, *_CONV3X3, [False, True, False])[1]
    return dw.permute(2, 3, 1, 0)


class _StdConv3x3(Function):
    @staticmethod
    def forward(ctx, x, w, b, ops, site):
        x, w = x.contiguous(), _cast(w, x)
        y = ops.std_conv3x3(x, w, b.float())
        ctx.save_for_backward(x, w, y)
        ctx.ops, ctx.site = ops, site
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        with trace.span("bwd", ctx.site, "/mask_bias"):
            gm, db = ctx.ops.relu_bias_grad(g.contiguous(), y)
        gn, xn = _nchw(gm), _nchw(x)
        with trace.span("bwd", ctx.site, "/dgrad"):
            wn = _oihw(w)
            dx = _std_dgrad(gn, xn, wn) if ctx.needs_input_grad[0] else None
        with trace.span("bwd", ctx.site, "/wgrad"):
            dw = _std_wgrad(gn, xn, wn)
        return dx, dw, db, None, None


class _StdConv3x3Dual(Function):
    @staticmethod
    def forward(ctx, skip, up, w, b, ops, site, offset):
        skip, up, w = skip.contiguous(), up.contiguous(), _cast(w, up)
        c = skip.shape[-1]
        y = ops.std_conv3x3_dual(skip, up, w[:, :, :c], w[:, :, c:],
                                 b.float(), offset=offset)
        ctx.save_for_backward(skip, up, w, y)
        ctx.ops, ctx.site, ctx.offset = ops, site, offset
        return y

    @staticmethod
    def backward(ctx, g):
        skip, up, w, y = ctx.saved_tensors
        (oh, ow), (_, h, wd, c) = ctx.offset, up.shape
        with trace.span("bwd", ctx.site, "/mask_bias"):
            gm, db = ctx.ops.relu_bias_grad(g.contiguous(), y)
        gn, upn = _nchw(gm), _nchw(up)
        with trace.span("bwd", ctx.site, "/dgrad"):
            wan, wbn = _oihw(w[:, :, :c]), _oihw(w[:, :, c:])
            dskip = dup = None
            if ctx.needs_input_grad[0]:  # the crop has up's shape
                dskip = skip.new_zeros(skip.shape)
                dskip[:, oh : oh + h, ow : ow + wd] = _std_dgrad(gn, upn, wan)
            if ctx.needs_input_grad[1]:
                dup = _std_dgrad(gn, upn, wbn)
        with trace.span("bwd", ctx.site, "/wgrad"):
            crop = _nchw(skip[:, oh : oh + h, ow : ow + wd])
            dw = torch.cat([_std_wgrad(gn, crop, wan),
                            _std_wgrad(gn, upn, wbn)], dim=2)
        return dskip, dup, dw, db, None, None, None


def conv2x2_t(x, w, b4, relu=True, *, ops=KERNEL_OPS, site=""):
    """Trainable H1: [N,hp,wp,4C] x [2,2,4C,4O] → [N,hp-1,wp-1,4O]."""
    _relu_only(relu)
    return _Conv2x2.apply(x, w, b4, ops, site)


def conv2x2_pool_t(x, w, b4, relu=True, *, ops=KERNEL_OPS, site=""):
    """Trainable H1 with the 2×2/2 max pool: (y [N,hp-1,wp-1,4O], its pool
    [..,O]), the pool's gradient to the first slot attaining the max, as
    conv2x2_t followed by unet_fast.pool4_select."""
    _relu_only(relu)
    return _Conv2x2Pool.apply(x, w, b4, ops, site)


def conv2x2_dual_t(skip, up, wa, wb, b4, relu=True, *, offset=(0, 0),
                   ops=KERNEL_OPS, site=""):
    """Trainable H2 (concat-free decoder conv): skip [N,hpa,wpa,4C] read
    through its center crop at the UNPACKED ``offset`` (even: a packed
    slice; odd: a slot phase), up [N,hp,wp,4C] → [N,hp-1,wp-1,4O]; the
    skip's gradient has its shape, zero outside the crop."""
    _relu_only(relu)
    oh, ow = (int(v) for v in offset)
    n, hp, wp, c4 = up.shape
    if (skip.shape[0] != n or skip.shape[3] != c4 or oh < 0 or ow < 0
            or oh + 2 * hp > 2 * skip.shape[1]
            or ow + 2 * wp > 2 * skip.shape[2]):
        raise ValueError(f"conv2x2_dual_t: the crop {offset} of the skip "
                         f"{tuple(skip.shape)} does not cover up "
                         f"{tuple(up.shape)}")
    return _Conv2x2Dual.apply(skip, up, wa, wb, b4, ops, site, (oh, ow))


def conv4x4s2_t(x, w4, b4, relu=True, *, ops=KERNEL_OPS, site=""):
    """Trainable H3: unpacked [N,H,W,C] → packed [N,(H-2)//2,(W-2)//2,4O]
    (the image entry too, C = 3: its dx is skipped, the image needing no
    grad)."""
    _relu_only(relu)
    return _Conv4x4s2.apply(x, w4, b4, ops, site)


def matmul_rows_t(x, wm, b4, relu=True, *, ops=KERNEL_OPS, site=""):
    """Trainable H4 identity (2×2/2 deconv, unpacked input)."""
    _relu_only(relu)
    return _MatmulRows.apply(x, wm, b4, ops, site)


def deconv_packed_t(x4, wm, b4, relu=True, *, ops=KERNEL_OPS, site=""):
    """Trainable H4 scatter (2×2/2 deconv, packed in and out)."""
    _relu_only(relu)
    return _DeconvPacked.apply(x4, wm, b4, ops, site)


def std_conv3x3_t(x, w, b, *, ops=KERNEL_OPS, site=""):
    """Trainable H8 bf16: x [N,H,W,C], w [3,3,C,O], b [O] →
    relu(conv(x, w) + b) [N,H-2,W-2,O], rounded once to x's dtype."""
    return _StdConv3x3.apply(x, w, b, ops, site)


def std_conv3x3_dual_t(skip, up, w, b, *, offset, ops=KERNEL_OPS,
                       site=""):
    """Trainable H8 bf16 dual (the std decoder's concat-free first conv):
    skip [N,hs,ws,C] read at the crop origin ``offset``, up [N,H,W,C], w
    [3,3,2C,O] the concat weight (the skip's half first) → relu(conv(crop(
    skip), w[:, :, :C]) + conv(up, w[:, :, C:]) + b) [N,H-2,W-2,O]; the
    skip's gradient has its shape, zero outside the crop."""
    offset = tuple(int(v) for v in offset)
    return _StdConv3x3Dual.apply(skip, up, w, b, ops, site, offset)
