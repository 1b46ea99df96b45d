"""Paste per-roi mask probabilities back into full-image masks, on the device.

Port of `slowfast_vos_tpu/ops/paste_masks.py`: every image pixel samples its
roi's M x M mask at the inverse box transform, bilinear with
`align_corners=False` and torchvision's +1 box extent. Bilinear sampling is
separable, so the paste is two small batched matmuls per roi,
A_y @ mask @ A_x^T (`paste_masks.py:44-83`). A fused paste-and-union kernel
is later work.
"""
from __future__ import annotations

import torch


def _interp_matrix(coords: torch.Tensor, inside: torch.Tensor, m: int) -> torch.Tensor:
    """coords [N, L] continuous mask coordinates, inside [N, L] bool ->
    A [N, L, M] with A @ mask_axis == interpolated values."""
    c = coords.clamp(0.0, m - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    k = torch.arange(m, dtype=torch.float32, device=coords.device)
    is0 = k == c0[..., None]
    is1 = k == torch.clamp(c0 + 1, max=m - 1)[..., None]
    a = is0 * (1.0 - frac)[..., None] + is1 * frac[..., None]
    return a * inside[..., None]


def paste_masks_in_image(
    masks: torch.Tensor,
    boxes: torch.Tensor,
    image_hw: tuple[int, int],
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """masks [N, M, M] probabilities, boxes [N, 4] XYXY in image coordinates,
    valid optional [N] bool (invalid rois paste all-zero masks)
    -> [N, H, W] float32."""
    m = masks.shape[-1]
    h, w = image_hw
    # torchvision: integer box with TO_REMOVE=1 extent.
    x0 = torch.floor(boxes[:, 0])
    y0 = torch.floor(boxes[:, 1])
    bw = (torch.floor(boxes[:, 2]) - x0 + 1.0).clamp(min=1.0)
    bh = (torch.floor(boxes[:, 3]) - y0 + 1.0).clamp(min=1.0)

    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)
    # Image pixel -> continuous mask coordinate (align_corners=False).
    u = (xs[None, :] - x0[:, None] + 0.5) * (m / bw)[:, None] - 0.5  # [N, W]
    v = (ys[None, :] - y0[:, None] + 0.5) * (m / bh)[:, None] - 0.5  # [N, H]
    inside_x = (xs[None, :] >= x0[:, None]) & (xs[None, :] < x0[:, None] + bw[:, None])
    inside_y = (ys[None, :] >= y0[:, None]) & (ys[None, :] < y0[:, None] + bh[:, None])

    a_y = _interp_matrix(v, inside_y, m)  # [N, H, M]
    a_x = _interp_matrix(u, inside_x, m)  # [N, W, M]
    out = torch.bmm(torch.bmm(a_y, masks.to(torch.float32)), a_x.transpose(1, 2))
    if valid is not None:
        out = torch.where(valid[:, None, None], out, torch.zeros((), device=out.device))
    return out
