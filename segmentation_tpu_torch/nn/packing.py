"""The space-to-depth packed layout (segmentation_tpu.models.unet_fast
pack2/unpack2): [N, H, W, C] ↔ [N, H/2, W/2, 4, C], slot s = 2·dy + dx.
A packed tensor is stored flat as [N, H/2, W/2, 4C], slot-major."""

from __future__ import annotations

import torch


def pack2(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] → [N, H/2, W/2, 4, C]."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"space-to-depth packing needs even H/W, got {h}x{w}; use "
            "models.unet.UNet for odd input sizes"
        )
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4, c)


def unpack2(xp: torch.Tensor) -> torch.Tensor:
    """Inverse of pack2: [N, hp, wp, 4, C] → [N, 2hp, 2wp, C]."""
    n, hp, wp, _, c = xp.shape
    x = xp.reshape(n, hp, wp, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * hp, 2 * wp, c)


def view5(x4: torch.Tensor, c: int) -> torch.Tensor:
    """[N, hp, wp, 4C] → [N, hp, wp, 4, C]."""
    n, hp, wp, _ = x4.shape
    return x4.reshape(n, hp, wp, 4, c)


def crop_packed(skip: torch.Tensor, shape, offset) -> torch.Tensor:
    """Packed skip [N, hpa, wpa, 4C] center-cropped at the UNPACKED offset
    (oh, ow) to the packed ``shape`` [N, hp, wp, 4C]
    (segmentation_tpu.models.unet_fast.packed_center_crop_flat): even
    offsets are a packed slice (a view), odd ones a slot phase, where
    output slot (d, e) reads input slot ((oh+d) % 2, (ow+e) % 2) at packed
    offset ((oh+d) // 2, (ow+e) // 2)."""
    n, hp, wp, c4 = shape
    oh, ow = offset
    if oh % 2 == 0 and ow % 2 == 0:
        return skip[:, oh // 2 : oh // 2 + hp, ow // 2 : ow // 2 + wp]
    x5 = view5(skip, c4 // 4)
    slots = []
    for d in range(2):
        for e in range(2):
            ro, co = (oh + d) // 2, (ow + e) // 2
            src = 2 * ((oh + d) % 2) + (ow + e) % 2
            slots.append(x5[:, ro : ro + hp, co : co + wp, src])
    return torch.stack(slots, dim=3).reshape(n, hp, wp, c4)


def uncrop_packed(x: torch.Tensor, shape, offset) -> torch.Tensor:
    """The adjoint of crop_packed: x [N, hp, wp, 4C] placed into zeros of
    the skip's ``shape`` [N, hpa, wpa, 4C] at the crop of the UNPACKED
    offset (oh, ow)."""
    n, hp, wp, c4 = x.shape
    oh, ow = offset
    out = x.new_zeros(shape)
    if oh % 2 == 0 and ow % 2 == 0:
        out[:, oh // 2 : oh // 2 + hp, ow // 2 : ow // 2 + wp] = x
        return out
    o5, x5 = view5(out, c4 // 4), view5(x, c4 // 4)
    for d in range(2):
        for e in range(2):
            ro, co = (oh + d) // 2, (ow + e) // 2
            src = 2 * ((oh + d) % 2) + (ow + e) % 2
            o5[:, ro : ro + hp, co : co + wp, src] = x5[:, :, :, 2 * d + e]
    return out
