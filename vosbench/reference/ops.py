"""Plain PyTorch box, NMS, RoIAlign and paste operations of the reference.

A frozen copy of the port's plain versions (torchvision semantics: XYXY
boxes, `aligned=False` RoIAlign with 2x2 samples a bin, greedy NMS, the
+1-extent mask paste). Everything here is ordinary tensor code that
autograd differentiates; no kernel, no cache, no constant shared between
calls.
"""
from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)
NEG_INF = -1e10
ROI_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """[..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes, image_hw):
    h, w = image_hw
    return torch.stack([boxes[..., 0].clamp(0.0, w), boxes[..., 1].clamp(0.0, h),
                        boxes[..., 2].clamp(0.0, w), boxes[..., 3].clamp(0.0, h)], dim=-1)


def remove_small_boxes_mask(boxes, min_size):
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & ((boxes[..., 3] - boxes[..., 1]) >= min_size)


def _cxcywh(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def encode_boxes(reference, proposals, weights=(1.0, 1.0, 1.0, 1.0)):
    wx, wy, ww, wh = weights
    pcx, pcy, pw, ph = _cxcywh(proposals)
    gcx, gcy, gw, gh = _cxcywh(reference)
    pw, ph = pw.clamp(min=1e-6), ph.clamp(min=1e-6)
    return torch.stack([wx * (gcx - pcx) / pw, wy * (gcy - pcy) / ph,
                        ww * torch.log(gw.clamp(min=1e-6) / pw), wh * torch.log(gh.clamp(min=1e-6) / ph)], dim=-1)


def decode_boxes(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    wx, wy, ww, wh = weights
    pcx, pcy, pw, ph = _cxcywh(boxes)
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    cx = deltas[..., 0] / wx * pw + pcx
    cy = deltas[..., 1] / wy * ph + pcy
    w, h = torch.exp(dw) * pw, torch.exp(dh) * ph
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def sort_desc(x):
    """Descending along the last axis, the lower index first among ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def nms_keep(boxes, scores, valid, iou_threshold):
    """Exact greedy NMS of every problem [..., N] by fixpoint iteration over
    the score-sorted boxes. Returns keep [..., N] over the original indices."""
    eff = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(-eff, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.gather(eff, -1, order) > NEG_INF / 2
    n = sboxes.shape[-2]
    earlier = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    m = (box_iou(sboxes, sboxes) > iou_threshold) & earlier & svalid[..., :, None] & svalid[..., None, :]
    alive = svalid
    while True:
        new = svalid & ~(m & alive[..., :, None]).any(dim=-2)
        if torch.equal(new, alive):
            break
        alive = new
    return torch.zeros_like(alive).scatter(-1, order, alive)


def batched_nms_keep(boxes, scores, idxs, valid, iou_threshold):
    """Class-keyed NMS by the coordinate offset (torchvision `batched_nms`)."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    offsets = idxs.to(boxes.dtype) * (finite.amax(dim=(-2, -1)) + 1.0)[..., None]
    return nms_keep(boxes + offsets[..., None], scores, valid, iou_threshold)


def top_k_after_nms(keep, scores, k):
    """(indices [..., k], valid [..., k]) of the kept entries, score-descending."""
    eff = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    kk = min(k, eff.shape[-1])
    top_s, top_i = sort_desc(eff)
    top_s, top_i = top_s[..., :kk], top_i[..., :kk]
    if kk < k:
        pad = (*eff.shape[:-1], k - kk)
        top_i = torch.cat([top_i, top_i.new_zeros(pad)], dim=-1)
        top_s = torch.cat([top_s, top_s.new_full(pad, NEG_INF)], dim=-1)
    return top_i, top_s > NEG_INF / 2


def level_of(rois):
    """torchvision's LevelMapper over P2-P5, 0-based."""
    wh = rois[..., 2:] - rois[..., :2]
    area = (wh[..., 0] * wh[..., 1]).clamp(min=0.0)
    scale = torch.full((), 224.0, dtype=area.dtype, device=area.device)
    k = torch.floor(4 + torch.log2(torch.sqrt(area) / scale + 1e-6)).clamp(2, 5)
    return (k - 2).long()


def interp_matrix_1d(starts, bins, extent: int, out_size: int, sr: int):
    """[N, out, extent] matrix averaging the sr bilinear taps of each bin
    along one axis; samples outside [-1, extent] weigh zero."""
    dev = starts.device
    steps = torch.arange(out_size * sr, dtype=torch.float32, device=dev) + 0.5
    coords = starts[:, None] + steps[None, :] * (bins / torch.tensor(float(sr), device=dev))[:, None]
    in_range = (coords >= -1.0) & (coords <= extent)
    c = coords.clamp(0.0, extent - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    k = torch.arange(extent, dtype=torch.float32, device=dev)
    is0 = k[None, None, :] == c0[:, :, None]
    is1 = k[None, None, :] == torch.clamp(c0 + 1, max=extent - 1.0)[:, :, None]
    a = (is0 * (1.0 - frac)[:, :, None] + is1 * frac[:, :, None]) * in_range[:, :, None]
    return a.reshape(starts.shape[0], out_size, sr, extent).mean(dim=2)


def multiscale_roi_align(feats, rois, *, output_size: int, sampling_ratio: int = 2):
    """RoIAlign of rois [T, N, 4] (image coordinates) over levels [T, H_l,
    W_l, C] -> [T, N, out, out, C]: per roi, A_y . F_level . A_x^T with the
    separable `interp_matrix_1d` weights, which is the same average of 2x2
    bilinear samples a bin as torchvision's `aligned=False` RoIAlign.
    Differentiable by autograd with respect to the levels."""
    t, n = rois.shape[:2]
    c = feats[0].shape[-1]
    boxes = rois.to(torch.float32)
    levels = level_of(boxes)
    out = feats[0].new_zeros((t, n, output_size, output_size, c))
    out_t = torch.tensor(float(output_size), device=rois.device)
    for li, (f, scale) in enumerate(zip(feats, ROI_SCALES)):
        h, w = f.shape[1:3]
        for fr in range(t):
            idx = torch.nonzero(levels[fr] == li)[:, 0]
            for i in range(0, idx.numel(), 128):
                sel = idx[i : i + 128]
                x1, y1, x2, y2 = (boxes[fr, sel] * scale).unbind(-1)
                a_y = interp_matrix_1d(y1, (y2 - y1).clamp(min=1.0) / out_t, h, output_size, sampling_ratio)
                a_x = interp_matrix_1d(x1, (x2 - x1).clamp(min=1.0) / out_t, w, output_size, sampling_ratio)
                u = torch.einsum("nph,hwc->npwc", a_y.to(f.dtype), f[fr])
                pooled = torch.einsum("npwc,nqw->npqc", u, a_x.to(f.dtype))
                out = out.index_put((torch.full_like(sel, fr), sel), pooled)
    return out


def _paste_matrix(coords, inside, m: int):
    c = coords.clamp(0.0, m - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    k = torch.arange(m, dtype=torch.float32, device=coords.device)
    a = (k == c0[..., None]) * (1.0 - frac)[..., None] + (k == torch.clamp(c0 + 1, max=m - 1)[..., None]) * frac[..., None]
    return a * inside[..., None]


def paste_masks(masks, boxes, image_hw, valid):
    """masks [N, M, M] probabilities at boxes [N, 4] (image coordinates) ->
    [N, H, W]: each pixel samples its roi's mask bilinearly
    (`align_corners=False`) over the box's integer +1 extent; invalid rois
    paste zeros."""
    m = masks.shape[-1]
    h, w = image_hw
    x0, y0 = torch.floor(boxes[:, 0]), torch.floor(boxes[:, 1])
    bw = (torch.floor(boxes[:, 2]) - x0 + 1.0).clamp(min=1.0)
    bh = (torch.floor(boxes[:, 3]) - y0 + 1.0).clamp(min=1.0)
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)
    u = (xs[None] - x0[:, None] + 0.5) * (m / bw)[:, None] - 0.5
    v = (ys[None] - y0[:, None] + 0.5) * (m / bh)[:, None] - 0.5
    a_x = _paste_matrix(u, (xs[None] >= x0[:, None]) & (xs[None] < x0[:, None] + bw[:, None]), m)
    a_y = _paste_matrix(v, (ys[None] >= y0[:, None]) & (ys[None] < y0[:, None] + bh[:, None]), m)
    out = torch.bmm(torch.bmm(a_y, masks.to(torch.float32)), a_x.transpose(1, 2))
    return out * valid[:, None, None]
