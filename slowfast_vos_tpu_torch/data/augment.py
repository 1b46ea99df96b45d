"""Box/mask-aware geometric + color augmentations (host-side, cv2).

The port's copy of `slowfast_vos_tpu/data/augment.py`, with the same OpenCV
calls, so the same draws give the same pixels. It has the behavioral
semantics of the vendored DataAugmentationForObjectDetection library the
reference extends (`code/DataAugmentationForObjectDetection/data_aug/*`):

* flip / scale / rotate / translate / shear / letterbox-resize / HSV jitter;
* scale & translate & shear keep the original resolution, black-filling
  exposed canvas; rotate expands the canvas then resizes back;
* boxes follow the geometry (rotated boxes become the enclosing box of the
  rotated corners) and are dropped when more than (1 - alpha) of their area
  leaves the frame (the library's `clip_box` rule);
* the reference adds mask co-transforms and a `reset()` that re-samples
  parameters so one draw applies consistently across a temporal window
  (`dataset_osvos.py:43-68`). Here that contract is explicit: `sample()`
  returns a frozen parameter object whose `apply()` is deterministic, so the
  caller applies the same draw to every frame of the window.

Unlike the reference's per-mask Python lists, masks are a single [G, H, W]
array transformed in one vectorized call.

Dropping boxes would create dynamic shapes downstream, so `apply` returns a
`keep` mask instead; callers AND it into their gt validity mask.
"""
from __future__ import annotations

import dataclasses

import cv2
import numpy as np


def _box_area(b):
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def clip_box_keep(boxes: np.ndarray, bounds, alpha: float):
    """Clip boxes to `bounds` (x1,y1,x2,y2); keep those retaining at least
    `alpha`... precisely: drop when the lost area fraction >= (1 - alpha),
    matching the reference library's clip_box (`bbox_util.py:47-91`) for
    every box that intersects the canvas.

    Documented divergence: the library clips one-sidedly (x1 only against
    the left bound, x2 only against the right), so a box ENTIRELY beyond an
    edge becomes an inverted box whose fake positive area passes the keep
    rule — which then crashes torchvision's degenerate-box validation in the
    reference's own training. We clip two-sidedly and drop such boxes
    (zero retained area), which is behavior-identical in every run the
    reference itself can survive."""
    if len(boxes) == 0:
        return boxes, np.zeros((0,), bool)
    area = np.maximum(_box_area(boxes), 1e-9)
    clipped = boxes.copy()
    clipped[:, 0] = np.clip(clipped[:, 0], bounds[0], bounds[2])
    clipped[:, 1] = np.clip(clipped[:, 1], bounds[1], bounds[3])
    clipped[:, 2] = np.clip(clipped[:, 2], bounds[0], bounds[2])
    clipped[:, 3] = np.clip(clipped[:, 3], bounds[1], bounds[3])
    delta = (area - _box_area(clipped)) / area
    keep = delta < (1.0 - alpha)
    return clipped, keep


@dataclasses.dataclass(frozen=True)
class AppliedTransform:
    """Base: identity."""

    def apply(self, img, masks=None, boxes=None):
        keep = None if boxes is None else np.ones(len(boxes), bool)
        return img, masks, boxes, keep


@dataclasses.dataclass(frozen=True)
class Flip(AppliedTransform):
    flipped: bool = True

    def apply(self, img, masks=None, boxes=None):
        keep = None if boxes is None else np.ones(len(boxes), bool)
        if not self.flipped:
            return img, masks, boxes, keep
        w = img.shape[1]
        img = np.ascontiguousarray(img[:, ::-1])
        if masks is not None:
            masks = np.ascontiguousarray(masks[:, :, ::-1])
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            x1 = w - boxes[:, 2]
            x2 = w - boxes[:, 0]
            boxes[:, 0], boxes[:, 2] = x1, x2
        return img, masks, boxes, keep


@dataclasses.dataclass(frozen=True)
class Scale(AppliedTransform):
    """Resize by (1+sx, 1+sy) keeping the canvas size (crop or black-pad).

    Matches the library's `RandomScale.__call__` (`data_aug.py:151-186`)
    exactly: the copied region is `int(min(f, 1) * dim)` per axis (truncation,
    not the cv2-resized extent), and the clip bound is `[0, 0, 1 + w, h]` —
    the library's off-by-one x bound — with alpha 0.05."""

    sx: float = 0.0
    sy: float = 0.0
    alpha: float = 0.05

    def apply(self, img, masks=None, boxes=None):
        h, w = img.shape[:2]
        fx, fy = 1.0 + self.sx, 1.0 + self.sy
        resized = cv2.resize(img, None, fx=fx, fy=fy)
        canvas = np.zeros_like(img)
        yl = int(min(fy, 1.0) * h)
        xl = int(min(fx, 1.0) * w)
        canvas[:yl, :xl] = resized[:yl, :xl]
        img = canvas
        if masks is not None:
            out = np.zeros_like(masks)
            for i in range(masks.shape[0]):
                rm = cv2.resize(masks[i].astype(np.uint8), None, fx=fx, fy=fy)
                out[i, :yl, :xl] = rm[:yl, :xl]
            masks = out
        keep = None
        if boxes is not None and len(boxes):
            boxes = boxes * np.array([fx, fy, fx, fy])
            boxes, keep = clip_box_keep(boxes, (0, 0, 1 + w, h), self.alpha)
        elif boxes is not None:
            keep = np.zeros((0,), bool)
        return img, masks, boxes, keep


@dataclasses.dataclass(frozen=True)
class Translate(AppliedTransform):
    """Shift by (tx, ty) fractions of the canvas, black-filling.

    Library semantics (`data_aug.py:291-318`): the pixel shift is
    `int(t * dim)` — truncation toward zero, not rounding."""

    tx: float = 0.0
    ty: float = 0.0
    alpha: float = 0.25

    def apply(self, img, masks=None, boxes=None):
        h, w = img.shape[:2]
        dx, dy = int(self.tx * w), int(self.ty * h)
        mat = np.float32([[1, 0, dx], [0, 1, dy]])
        img = cv2.warpAffine(img, mat, (w, h))
        if masks is not None:
            masks = np.stack(
                [cv2.warpAffine(m.astype(np.uint8), mat, (w, h)) for m in masks]
            ).astype(masks.dtype)
        keep = None
        if boxes is not None and len(boxes):
            boxes = boxes + np.array([dx, dy, dx, dy], np.float64)
            boxes, keep = clip_box_keep(boxes, (0, 0, w, h), self.alpha)
        elif boxes is not None:
            keep = np.zeros((0,), bool)
        return img, masks, boxes, keep


def _rotate_expand(img, angle):
    h, w = img.shape[:2]
    cx, cy = w // 2, h // 2
    mat = cv2.getRotationMatrix2D((cx, cy), angle, 1.0)
    cos, sin = abs(mat[0, 0]), abs(mat[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    mat[0, 2] += nw / 2 - cx
    mat[1, 2] += nh / 2 - cy
    return cv2.warpAffine(img, mat, (nw, nh)), mat


@dataclasses.dataclass(frozen=True)
class Rotate(AppliedTransform):
    """Rotate about the center (expanded canvas, resized back), boxes becoming
    the enclosing box of their rotated corners."""

    angle: float = 0.0
    alpha: float = 0.05

    def apply(self, img, masks=None, boxes=None):
        h, w = img.shape[:2]
        rot, mat = _rotate_expand(img, self.angle)
        nh, nw = rot.shape[:2]
        img = cv2.resize(rot, (w, h))
        if masks is not None:
            new_masks = []
            for m in masks:
                rm, _ = _rotate_expand(m.astype(np.uint8), self.angle)
                new_masks.append(cv2.resize(rm, (w, h)))
            masks = np.stack(new_masks).astype(masks.dtype)
        keep = None
        if boxes is not None and len(boxes):
            corners = np.stack(
                [
                    boxes[:, [0, 1]],
                    boxes[:, [2, 1]],
                    boxes[:, [0, 3]],
                    boxes[:, [2, 3]],
                ],
                axis=1,
            )  # [N, 4, 2]
            ones = np.ones((*corners.shape[:2], 1))
            rot_corners = np.concatenate([corners, ones], axis=2) @ mat.T  # [N,4,2]
            enclosing = np.concatenate(
                [rot_corners.min(axis=1), rot_corners.max(axis=1)], axis=1
            )
            enclosing /= np.array([nw / w, nh / h, nw / w, nh / h])
            boxes, keep = clip_box_keep(enclosing, (0, 0, w, h), self.alpha)
        elif boxes is not None:
            keep = np.zeros((0,), bool)
        return img, masks, boxes, keep


@dataclasses.dataclass(frozen=True)
class Shear(AppliedTransform):
    """Horizontal shear by factor `sx` (library semantics: x' = x + sx*y).

    Mirrors `RandomShear.__call__` (`data_aug.py:577-604`) step for step,
    including its quirks: negative shear = flip → positive shear → flip back
    (the flip-back happens at the SHEARED width, before the resize); the box
    x-shift is int-truncated (`.astype(int)`); the resize-back divisor is the
    FLOAT sheared width / w; and there is NO clip_box — every box is kept.
    Masks (which the library's shear never handled) follow the image
    geometry exactly."""

    sx: float = 0.0

    def apply(self, img, masks=None, boxes=None):
        h, w = img.shape[:2]
        sx = abs(self.sx)
        flip_back = self.sx < 0
        if flip_back:  # library trick: negative shear = flip, shear, flip
            img, masks, boxes, _ = Flip().apply(img, masks, boxes)
        nw_f = w + sx * h  # float sheared width — the box divisor
        nw = int(nw_f)  # integer width for the raster ops
        mat = np.float32([[1, sx, 0], [0, 1, 0]])
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] += (boxes[:, [1, 3]] * sx).astype(int)
        img = cv2.warpAffine(img, mat, (nw, h))
        if masks is not None:
            masks = np.stack(
                [cv2.warpAffine(m.astype(np.uint8), mat, (nw, h)) for m in masks]
            ).astype(masks.dtype)
        if flip_back:  # flipped back at the sheared width, before the resize
            img, masks, boxes, _ = Flip().apply(img, masks, boxes)
        img = cv2.resize(img, (w, h))
        if masks is not None:
            masks = np.stack([cv2.resize(m.astype(np.uint8), (w, h)) for m in masks]).astype(
                masks.dtype
            )
        keep = None
        if boxes is not None:
            if len(boxes):
                boxes[:, [0, 2]] /= nw_f / w
            keep = np.ones(len(boxes), bool)  # the library's shear never clips
        return img, masks, boxes, keep


@dataclasses.dataclass(frozen=True)
class HSVShift(AppliedTransform):
    """Additive "hue/saturation/brightness" jitter.

    The library's `RandomHSV.__call__` (`data_aug.py:770-786`) never converts
    to HSV: it adds the three offsets to the RAW channels of whatever color
    space the image is in, clips to [0, 255], then re-clips channel 0 to
    [0, 179] (the HSV hue cap applied to a non-HSV channel). Replicated
    verbatim for distribution parity."""

    dh: int = 0
    ds: int = 0
    dv: int = 0

    def apply(self, img, masks=None, boxes=None):
        keep = None if boxes is None else np.ones(len(boxes), bool)
        out = img.astype(int) + np.array([self.dh, self.ds, self.dv], int)
        out = np.clip(out, 0, 255)
        out[:, :, 0] = np.clip(out[:, :, 0], 0, 179)
        return out.astype(np.uint8), masks, boxes, keep


@dataclasses.dataclass(frozen=True)
class Letterbox(AppliedTransform):
    """Aspect-preserving resize CENTERED on a black `size` x `size` canvas —
    the library's `Resize` + `letterbox_image` (`data_aug.py:654-705`,
    `bbox_util.py:239-268`): resized extent is int-truncated, the canvas
    offset is `(size - new) // 2`, and the box offset is the FLOAT centering
    delta truncated via `.astype(int)`."""

    size: int = 608

    def apply(self, img, masks=None, boxes=None):
        h, w = img.shape[:2]
        scale = min(self.size / h, self.size / w)
        nh, nw = int(h * scale), int(w * scale)
        oy, ox = (self.size - nh) // 2, (self.size - nw) // 2
        canvas = np.zeros((self.size, self.size, 3), np.uint8)
        canvas[oy : oy + nh, ox : ox + nw] = cv2.resize(img, (nw, nh))
        if masks is not None:
            out = np.zeros((masks.shape[0], self.size, self.size), masks.dtype)
            for i, m in enumerate(masks):
                out[i, oy : oy + nh, ox : ox + nw] = cv2.resize(m.astype(np.uint8), (nw, nh))
            masks = out
        keep = None if boxes is None else np.ones(len(boxes), bool)
        if boxes is not None and len(boxes):
            # library: bboxes += [[del_w, del_h, del_w, del_h]].astype(int)
            # where del = (size - scale*dim) / 2 as a FLOAT of the exact
            # (untruncated) resized extent.
            del_h = int((self.size - scale * h) / 2)
            del_w = int((self.size - scale * w) / 2)
            boxes = boxes * scale + np.array([del_w, del_h, del_w, del_h])
        return canvas, masks, boxes, keep


# --- random samplers ---------------------------------------------------------


class RandomFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def sample(self, rng: np.random.Generator) -> Flip:
        return Flip(flipped=bool(rng.random() < self.p))


class RandomScale:
    def __init__(self, scale=0.2, diff: bool = False, alpha: float = 0.05):
        self.range = scale if isinstance(scale, tuple) else (max(-1.0, -scale), scale)
        self.diff = diff
        self.alpha = alpha

    def sample(self, rng: np.random.Generator) -> Scale:
        sx = rng.uniform(*self.range)
        sy = rng.uniform(*self.range) if self.diff else sx
        return Scale(sx=sx, sy=sy, alpha=self.alpha)


class RandomRotate:
    def __init__(self, angle=10.0, alpha: float = 0.05):
        self.range = angle if isinstance(angle, tuple) else (-angle, angle)
        self.alpha = alpha

    def sample(self, rng: np.random.Generator) -> Rotate:
        return Rotate(angle=rng.uniform(*self.range), alpha=self.alpha)


class RandomTranslate:
    def __init__(self, translate=0.2, diff: bool = False, alpha: float = 0.25):
        self.range = translate if isinstance(translate, tuple) else (-translate, translate)
        self.diff = diff
        self.alpha = alpha

    def sample(self, rng: np.random.Generator) -> Translate:
        tx = rng.uniform(*self.range)
        ty = rng.uniform(*self.range) if self.diff else tx
        return Translate(tx=tx, ty=ty, alpha=self.alpha)


class RandomShear:
    def __init__(self, shear=0.2):
        self.range = shear if isinstance(shear, tuple) else (-shear, shear)

    def sample(self, rng: np.random.Generator) -> Shear:
        return Shear(sx=rng.uniform(*self.range))


class RandomHSV:
    def __init__(self, hue=0, saturation=0, brightness=0):
        as_range = lambda v: v if isinstance(v, tuple) else (-v, v)
        self.h, self.s, self.v = as_range(hue), as_range(saturation), as_range(brightness)

    def sample(self, rng: np.random.Generator) -> HSVShift:
        return HSVShift(
            dh=int(rng.integers(self.h[0], self.h[1] + 1)),
            ds=int(rng.integers(self.s[0], self.s[1] + 1)),
            dv=int(rng.integers(self.v[0], self.v[1] + 1)),
        )


def apply_sequence(transforms, img, masks=None, boxes=None):
    """Apply sampled transforms left-to-right, AND-ing the keep masks and
    compacting kept boxes/masks as the library does."""
    keep_all = None if boxes is None else np.ones(len(boxes), bool)
    for t in transforms:
        img, masks, boxes, keep = t.apply(img, masks, boxes)
        if boxes is not None and keep is not None:
            boxes = boxes[keep]
            if masks is not None:
                masks = masks[keep]
            keep_idx = np.where(keep_all)[0][keep] if keep_all is not None else None
            keep_all = np.zeros_like(keep_all)
            keep_all[keep_idx] = True
    return img, masks, boxes, keep_all
