"""Trainable packed sites (segmentation_tpu.nn.pallas.train).

Five ``torch.autograd.Function``s over one ``Ops`` (the hand kernels H1–H4
and H6 by default, their plain versions with ``PLAIN_OPS``). Each forward
runs one packed-site op of ``ops`` and saves its input(s), the weight cast
to the input's dtype, and its output, as the JAX wrappers' save-output
variant does. Each backward masks the cotangent with y > 0 (every train site ends in a ReLU,
and y > 0 exactly where the pre-activation is), then:

  conv2x2_t        dx by H6, dw by conv2x2_wgrad, db
  conv2x2_dual_t   dxa and dxb by H6's dual mode, dwa, dwb, db
  conv4x4s2_t      dx and dw plain (torch.nn.grad; XLA in the JAX package)
  matmul_rows_t    dx = g wmᵀ, dwm = xᵀ g
  deconv_packed_t  the same on the unpacked input, dx packed again

dx keeps the input's dtype and dw comes back in it too (bf16 in training,
as the JAX package's transpose of a bf16 conv); autograd casts dw to the
f32 parameter's grad. Only ``relu=True`` is taken: every train site has
it, and the kernels fuse it. The JAX package's recompute-mask variant
(``SEG_PALLAS_TRAIN=2``) is not ported.
"""

from __future__ import annotations

import torch
from torch.autograd import Function

from segmentation_tpu_torch.nn.kernels.conv_bwd import bias_grad, conv2x2_wgrad
from segmentation_tpu_torch.nn.kernels.conv_flat import KERNEL_OPS
from segmentation_tpu_torch.nn.packing import pack2, unpack2, view5


def _relu_only(relu: bool) -> None:
    if not relu:
        raise ValueError("the trainable packed sites take relu=True only")


def _cast(w, x):
    return w.to(x.dtype).contiguous()


def _mask(g, y):
    return torch.where(y > 0, g, 0.0).contiguous()


def _flat_wgrad(x, g):
    """xᵀ g over every pixel: [C, 4O]."""
    return x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])


class _Conv2x2(Function):
    @staticmethod
    def forward(ctx, x, w, b4, ops):
        x, w = x.contiguous(), _cast(w, x)
        y = ops.packed_conv2x2(x, w, b4.float())
        ctx.save_for_backward(x, w, y)
        ctx.ops = ops
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = _mask(g, y)
        dx = (ctx.ops.packed_conv2x2_dgrad(g, w)
              if ctx.needs_input_grad[0] else None)
        return dx, conv2x2_wgrad(x, g), bias_grad(g), None


class _Conv2x2Dual(Function):
    @staticmethod
    def forward(ctx, xa, xb, wa, wb, b4, ops):
        xa, xb = xa.contiguous(), xb.contiguous()
        wa, wb = _cast(wa, xb), _cast(wb, xb)
        y = ops.packed_conv2x2_dual(xa, xb, wa, wb, b4.float(),
                                    offset=(0, 0))
        ctx.save_for_backward(xa, xb, wa, wb, y)
        ctx.ops = ops
        return y

    @staticmethod
    def backward(ctx, g):
        xa, xb, wa, wb, y = ctx.saved_tensors
        g = _mask(g, y)
        dxa, dxb = ctx.ops.packed_conv2x2_dgrad_dual(g, wa, wb)
        return (dxa, dxb, conv2x2_wgrad(xa, g), conv2x2_wgrad(xb, g),
                bias_grad(g), None)


class _Conv4x4s2(Function):
    @staticmethod
    def forward(ctx, x, w4, b4, ops):
        x, w4 = x.contiguous(), _cast(w4, x)
        y = ops.strided_conv4x4s2(x, w4, b4.float())
        ctx.save_for_backward(x, w4, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w4, y = ctx.saved_tensors
        g = _mask(g, y)
        gn = g.permute(0, 3, 1, 2)
        xn, wn = x.permute(0, 3, 1, 2), w4.permute(3, 2, 0, 1)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xn.shape, wn, gn, stride=2)
            dx = dx.permute(0, 2, 3, 1).contiguous()
        dw = torch.nn.grad.conv2d_weight(xn, wn.shape, gn, stride=2)
        return dx, dw.permute(2, 3, 1, 0), bias_grad(g), None


class _MatmulRows(Function):
    @staticmethod
    def forward(ctx, x, wm, b4, ops):
        x, wm = x.contiguous(), _cast(wm, x)
        y = ops.rows_matmul(x, wm, b4.float(), scatter=False)
        ctx.save_for_backward(x, wm, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, wm, y = ctx.saved_tensors
        g = _mask(g, y)
        return g @ wm.T, _flat_wgrad(x, g), bias_grad(g), None


class _DeconvPacked(Function):
    @staticmethod
    def forward(ctx, x4, wm, b4, ops):
        x4, wm = x4.contiguous(), _cast(wm, x4)
        y = ops.rows_matmul(x4, wm, b4.float(), scatter=True)
        ctx.save_for_backward(x4, wm, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x4, wm, y = ctx.saved_tensors
        g = _mask(g, y)
        n, i, j, c4 = x4.shape
        xu = unpack2(view5(x4, c4 // 4))  # [N, 2i, 2j, C]
        dx = pack2(g @ wm.T).reshape(n, i, j, c4)
        return dx, _flat_wgrad(xu, g), bias_grad(g), None


def conv2x2_t(x, w, b4, relu=True, *, ops=KERNEL_OPS):
    """Trainable H1: [N,hp,wp,4C] x [2,2,4C,4O] → [N,hp-1,wp-1,4O]."""
    _relu_only(relu)
    return _Conv2x2.apply(x, w, b4, ops)


def conv2x2_dual_t(xa, xb, wa, wb, b4, relu=True, *, ops=KERNEL_OPS):
    """Trainable H2 (concat-free decoder conv), same-shape operands: the
    skip crop is taken before the call."""
    _relu_only(relu)
    if xa.shape != xb.shape:
        raise ValueError(f"conv2x2_dual_t: operands {tuple(xa.shape)} and "
                         f"{tuple(xb.shape)} differ; crop the skip first")
    return _Conv2x2Dual.apply(xa, xb, wa, wb, b4, ops)


def conv4x4s2_t(x, w4, b4, relu=True, *, ops=KERNEL_OPS):
    """Trainable H3: unpacked [N,H,W,C] → packed [N,(H-2)//2,(W-2)//2,4O]."""
    _relu_only(relu)
    return _Conv4x4s2.apply(x, w4, b4, ops)


def matmul_rows_t(x, wm, b4, relu=True, *, ops=KERNEL_OPS):
    """Trainable H4 identity (2×2/2 deconv, unpacked input)."""
    _relu_only(relu)
    return _MatmulRows.apply(x, wm, b4, ops)


def deconv_packed_t(x4, wm, b4, relu=True, *, ops=KERNEL_OPS):
    """Trainable H4 scatter (2×2/2 deconv, packed in and out)."""
    _relu_only(relu)
    return _DeconvPacked.apply(x4, wm, b4, ops)
