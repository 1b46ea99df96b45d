"""Clip-level inference: one superchunk of frames at a time, end to end on
the device.

Port of `slowfast_vos_tpu/models/pipeline.py` (`pipeline.py:201-455`). A
superchunk of SC frames plus the F-1 temporal halo runs

  1. transform (resize, normalize, pad) and the frozen ResNet-50 + FPN,
  2. masking of frames beyond the sequence ends (before the RPN),
  3. RPN + proposal filtering on the SC centre frames,
  4. SlowFast enhancement of P2-P5 over the window (pre-padded mode),
  5. RoI heads: one 7x7 RoIAlign launch over all [SC, 1000] proposals, box
     head, postprocess to the top detections, one 14x14 RoIAlign launch
     over [SC, D], mask head,
  6. finalize at original resolution: inverse boxes, paste, union >= 0.5,
     bit-packed along the width.

`infer_sequence` streams a clip through superchunks. After the first, each
chunk computes the backbone for its SC new frames only and carries the F-1
overlap frames' features over from the previous chunk. With
`instance_masks=True` it returns each detection's pasted mask probabilities
as well (JAX `_finalize_instances_impl`). `compute_sequence_features` runs
only the frozen backbone and the RPN over a sequence (the proposal dump of
`train/pretrain.py`).

On the card every superchunk runs as a CUDA graph, one per superchunk shape
(`models/graphs.py`: the counterpart of the JAX package's one compiled
executable per superchunk); `Pipeline(..., graphs=False)` runs it eagerly,
the CPU always does. Each window reaches the card from page-locked host
memory without a host synchronize, so a run waits for the card only where
`frame_detections` fetches its results.

Tracer spans (`utils/profiling.py::TRACER`): `pipeline.infer_sequence` (a
unit of work) > `pipeline.infer_chunks` > `pipeline.chunk_inputs`,
`graphs.run`; `pipeline.fetch` > `pipeline.fetch_wait` (the copies to the
host). Counter: `pipeline.frames` (real frames). Stage marks of `_superchunk`, read under graphs:
`transform`, `backbone`, `rpn`, `slowfast`, `roi_heads`, `finalize`; with `arch="vitdet-b"` the
backbone's own (`models/vit.py`) come before `backbone`.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from slowfast_vos_tpu_torch.models.anchors import fpn_anchors
from slowfast_vos_tpu_torch.models.config import DetectionConfig, SlowFastConfig
from slowfast_vos_tpu_torch.models.graphs import SuperchunkGraphs
from slowfast_vos_tpu_torch.models.heads import postprocess_detections
from slowfast_vos_tpu_torch.models.layers import lecun_normal_
from slowfast_vos_tpu_torch.models.resnet_fpn import FPN_STRIDES
from slowfast_vos_tpu_torch.models.rpn import filter_proposals
from slowfast_vos_tpu_torch.models.segmentation import SlowFastMaskRCNN
from slowfast_vos_tpu_torch.models.transform import ImageTransform
from slowfast_vos_tpu_torch.models.vit import ViTConfig
from slowfast_vos_tpu_torch.ops.constants import device_constant
from slowfast_vos_tpu_torch.ops.paste_masks import paste_masks_in_image
from slowfast_vos_tpu_torch.ops.roi_align import ROI_SCALES, multiscale_roi_align
from slowfast_vos_tpu_torch.utils.profiling import TRACER

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(x: torch.Tensor) -> torch.Tensor:
    """`np.packbits(x, axis=-1)` for a bool tensor: big-endian bit order, the
    last axis zero-padded to a multiple of 8."""
    w = x.shape[-1]
    x = torch.nn.functional.pad(x.to(torch.uint8), (0, -w % 8))
    bits = x.reshape(*x.shape[:-1], -1, 8)
    weights = device_constant(_BIT_WEIGHTS, torch.uint8, x.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def frame_detections(chunk_outputs: list, t: int, width: int, instance_masks: bool = False) -> list[dict[str, Any]]:
    """The per-frame detection dicts of `infer_sequence` from its chunks'
    outputs (each a tuple of 5 device tensors with a leading frame axis),
    fetched to the host at once; the first `t` frames are kept."""
    with TRACER.span("pipeline.fetch"):
        with TRACER.span("pipeline.fetch_wait"):
            fboxes, fscores, flabels, fvalid, fmasks = (
                torch.cat([outs[i] for outs in chunk_outputs])[:t].cpu().numpy() for i in range(5)
            )
        out: list[dict[str, Any]] = []
        for g in range(t):
            if instance_masks:
                union = ((fmasks[g] >= 0.5) & fvalid[g][:, None, None]).any(0)
            else:
                union = np.unpackbits(fmasks[g], axis=-1, count=width).astype(bool)
            det = {
                "boxes": fboxes[g],
                "scores": fscores[g],
                "labels": flabels[g],
                "valid": fvalid[g],
                "union_mask": union,
            }
            if instance_masks:
                det["masks"] = fmasks[g]
            out.append(det)
        return out


class Pipeline:
    """Binds a model and the static geometry of one input resolution.

    `graphs`: run each superchunk through its CUDA graph (`models/graphs.py`;
    default: where the model is on a CUDA device); False runs it eagerly, as
    the CPU does. Asking for graphs off the card raises."""

    def __init__(self, model: SlowFastMaskRCNN, transform: ImageTransform, *, superchunk: int = 32,
                 graphs: bool | None = None):
        self.model = model.eval()
        self.cfg: DetectionConfig = model.cfg
        self.sf: SlowFastConfig = model.sf
        self.transform = transform
        self.superchunk = superchunk
        self.device = next(model.parameters()).device

        ch, cw = transform.canvas_hw
        self.feature_hws = [(ch // s, cw // s) for s in FPN_STRIDES]
        self.anchors = [torch.from_numpy(a).to(self.device) for a in fpn_anchors(self.feature_hws)]
        # torchvision clips proposals to the resized (un-padded) image extent.
        self.image_hw = (float(transform.resized_hw[0]), float(transform.resized_hw[1]))

        f = self.sf.fast
        self.halo_left = f // 2
        self.halo_right = -(-f // 2) - 1

        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"CUDA graphs run on a CUDA device; this pipeline's model is on {self.device}")
        self.graphs = SuperchunkGraphs(self) if (on_card if graphs is None else graphs) else None

    def _roi_forward(self, enhanced, proposals, pvalid):
        """enhanced: 4 levels [E, h, w, 256]; proposals [E, P, 4] -> detections."""
        e, p = proposals.shape[:2]
        cfg = self.cfg
        enhanced = [fl.contiguous() for fl in enhanced]
        pooled7 = multiscale_roi_align(enhanced, proposals, ROI_SCALES, output_size=7)
        cls, reg = self.model.box_predict(pooled7.reshape(e * p, *pooled7.shape[2:]))
        cls = cls.reshape(e, p, -1)
        reg = reg.reshape(e, p, cfg.num_classes, 4)
        boxes, scores, labels, dvalid = postprocess_detections(
            cls, reg, proposals, pvalid, self.image_hw, cfg
        )

        d, mo = boxes.shape[1], cfg.mask_out_size
        pooled14 = multiscale_roi_align(enhanced, boxes, ROI_SCALES, output_size=cfg.mask_roi_size)
        mask_logits = self.model.mask_predict(pooled14.reshape(e * d, *pooled14.shape[2:]))
        mask_logits = mask_logits.reshape(e, d, mo, mo, cfg.num_classes)
        sel = labels.long()[:, :, None, None, None].expand(e, d, mo, mo, 1)
        mask_probs = torch.sigmoid(torch.gather(mask_logits, 4, sel))[..., 0]
        return boxes, scores, labels, dvalid, mask_probs

    def _finalize_instances(self, boxes, scores, labels, valid, mask_probs):
        """Canvas-space detections -> original-resolution boxes and every
        detection's pasted mask probabilities [E, D, H, W]."""
        e, d = valid.shape
        h, w = self.transform.original_hw
        orig_boxes = self.transform.inverse_boxes(boxes)
        masks = paste_masks_in_image(
            mask_probs.reshape(e * d, *mask_probs.shape[2:]), orig_boxes.reshape(-1, 4),
            (h, w), valid.reshape(-1),
        ).reshape(e, d, h, w)
        return orig_boxes, scores, labels, valid, masks

    def _finalize(self, *detections):
        """`_finalize_instances` reduced to the per-frame union mask (>= 0.5),
        bit-packed along the width."""
        orig_boxes, scores, labels, valid, masks = self._finalize_instances(*detections)
        union = ((masks >= 0.5) & valid[:, :, None, None]).any(dim=1)
        return orig_boxes, scores, labels, valid, packbits(union)

    def _detect_finalize(self, feats, feat_valid, sc, instance_masks=False):
        """Masked features -> RPN -> SlowFast -> RoI heads -> finalize.
        Returns (outputs, carry): carry is the last F-1 frames' masked
        features of all 5 levels, the next window's overlap."""
        # Frames beyond the sequence ends contribute zeros to the temporal
        # convs (reference zero padding).
        zero = torch.zeros((), dtype=feats[0].dtype, device=feats[0].device)
        feats = [torch.where(feat_valid[:, None, None, None], fl, zero) for fl in feats]
        TRACER.mark("backbone")

        center = slice(self.halo_left, self.halo_left + sc)
        obj, dlt = self.model.rpn_predict([fl[center] for fl in feats])
        proposals, _scores, pvalid = filter_proposals(
            obj, dlt, self.anchors, image_hw=self.image_hw, cfg=self.cfg
        )
        TRACER.mark("rpn")
        enhanced = self.model.enhance(feats[:4], pre_padded=True)
        TRACER.mark("slowfast")
        finalize = self._finalize_instances if instance_masks else self._finalize
        detections = self._roi_forward(enhanced, proposals, pvalid)
        TRACER.mark("roi_heads")
        outs = finalize(*detections)
        TRACER.mark("finalize")
        return outs, [fl[sc:] for fl in feats]

    def _superchunk(self, images, feat_valid, carry=None, instance_masks=False):
        """images: [SC + F - 1, H0, W0, 3] (no carry) or the SC new frames
        (carry: 5 levels [F-1, h, w, 256] of the overlap frames); feat_valid:
        [SC + F - 1] for the full window."""
        canvas = self.transform(images)
        TRACER.mark("transform")
        feats = self.model.backbone_feats(canvas)
        if carry is not None:
            feats = [torch.cat([cf, nf]) for cf, nf in zip(carry, feats)]
        sc = feats[0].shape[0] - (self.sf.fast - 1)
        return self._detect_finalize(feats, feat_valid, sc, instance_masks)

    def _run(self, images, feat_valid, carry=None, instance_masks=False):
        """`_superchunk` on device inputs: replayed from its CUDA graph where
        the pipeline has graphs, else eagerly. Returns (outputs, carry), each
        tensor the caller's own."""
        if self.graphs is None:
            return self._superchunk(images, feat_valid, carry, instance_masks)
        return self.graphs.run(images, feat_valid, carry, instance_masks)

    @torch.inference_mode()
    def forward_superchunk(self, images: torch.Tensor, feat_valid: torch.Tensor):
        """Public full-pipeline forward on one superchunk.

        images: [SC + F - 1, H0, W0, 3] uint8/float (halo frames included);
        feat_valid: [SC + F - 1] bool (False for zero halo frames beyond the
        sequence ends). Returns (orig_boxes [SC, D, 4], scores [SC, D],
        labels [SC, D], valid [SC, D], packed union masks [SC, H0, ceil(W0/8)])."""
        images = torch.as_tensor(images, device=self.device)
        feat_valid = torch.as_tensor(feat_valid, dtype=torch.bool, device=self.device)
        return self._run(images, feat_valid)[0]

    @torch.inference_mode()
    def compute_sequence_features(self, images: np.ndarray):
        """The frozen backbone and the RPN over a whole sequence, a
        superchunk of frames at a time (JAX `pipeline.py:337`).

        images: [T, H, W, 3] uint8 (or float32 in [0,1]) at original
        resolution. Returns (feats_padded: 4 levels [T + F - 1, h, w, 256]
        with the zero halo, proposals [T, P, 4], pvalid [T, P]), on the
        device."""
        feats_parts, prop_parts, pvalid_parts = [], [], []
        for i in range(0, images.shape[0], self.superchunk):
            batch = torch.from_numpy(np.ascontiguousarray(images[i : i + self.superchunk])).to(self.device)
            feats = self.model.backbone_feats(self.transform(batch))
            obj, dlt = self.model.rpn_predict(feats)
            proposals, _scores, pvalid = filter_proposals(
                obj, dlt, self.anchors, image_hw=self.image_hw, cfg=self.cfg
            )
            feats_parts.append(feats[:4])
            prop_parts.append(proposals)
            pvalid_parts.append(pvalid)
        pad = (0, 0, 0, 0, 0, 0, self.halo_left, self.halo_right)
        feats_padded = [
            torch.nn.functional.pad(torch.cat([p[lvl] for p in feats_parts]), pad) for lvl in range(4)
        ]
        return feats_padded, torch.cat(prop_parts), torch.cat(pvalid_parts)

    @torch.inference_mode()
    def infer_sequence(
        self, images: np.ndarray, *, instance_masks: bool = False, transport: str = "rgb"
    ) -> list[dict[str, Any]]:
        """Full-sequence inference at original resolution.

        images: [T, H, W, 3] uint8 (or float32 in [0,1]). Returns one dict per
        frame: boxes [D, 4], scores [D], labels [D], valid [D], union_mask
        [H, W] bool, and with `instance_masks=True` masks [D, H, W], each
        detection's pasted mask probabilities. All outputs stay on the device
        until one fetch at the end."""
        if transport != "rgb":  # the only form; kept as a keyword because the benchmark's drivers pass it
            raise ValueError(f'transport must be "rgb", not {transport!r}')
        with TRACER.span("pipeline.infer_sequence", unit=True):
            pending = self.infer_chunks(images, instance_masks=instance_masks)
            return frame_detections(pending, images.shape[0], images.shape[2], instance_masks)

    @torch.inference_mode()
    def infer_chunks(self, images: np.ndarray, *, instance_masks: bool = False) -> list:
        """The superchunks of `infer_sequence`, each one's outputs left on the
        device: the host's part of a run, which never waits for the card."""
        use_carry = self.sf.fast > 1  # F = 1 has no overlap to carry
        carry = None
        pending = []
        with TRACER.span("pipeline.infer_chunks"):
            t = images.shape[0]
            for c in range(0, t, self.superchunk):
                outs, next_carry = self.chunk_step(images, c, carry, instance_masks)
                carry = next_carry if use_carry else None
                pending.append(outs)
            TRACER.count("pipeline.frames", t)
        return pending

    def chunk_inputs(self, images: np.ndarray, c: int, carried: bool):
        """The device inputs of the superchunk that starts at frame `c` of
        `images` [T, H, W, 3]: its window (the SC new frames when the overlap
        is `carried`, else with the halo; frames outside [0, T) zero), and
        feat_valid over the full window. On the card both are staged in
        page-locked host memory, so that their upload neither waits for the
        card nor makes it wait."""
        with TRACER.span("pipeline.chunk_inputs"):
            t = images.shape[0]
            widxs = np.arange(c - self.halo_left, c + self.superchunk + self.halo_right)
            idxs = widxs[self.sf.fast - 1 :] if carried else widxs
            outside = (idxs < 0) | (idxs >= t)
            pin = self.device.type == "cuda"
            window = torch.empty((len(idxs), *images.shape[1:]), dtype=torch.from_numpy(images[:0]).dtype,
                                 pin_memory=pin)
            np.take(images, np.clip(idxs, 0, t - 1), axis=0, out=window.numpy())
            window.numpy()[outside] = 0
            valid = torch.empty(len(widxs), dtype=torch.bool, pin_memory=pin)
            valid.numpy()[:] = (widxs >= 0) & (widxs < t)
            upload = lambda x: x.to(self.device, non_blocking=True)  # noqa: E731
            return upload(window), upload(valid)

    def chunk_step(self, images: np.ndarray, c: int, carry=None, instance_masks: bool = False):
        """The superchunk of `infer_sequence` that starts at frame `c` of
        `images` [T, H, W, 3] through `_run`. Returns (outputs, carry)."""
        dev_images, dev_valid = self.chunk_inputs(images, c, carry is not None)
        return self._run(dev_images, dev_valid, carry, instance_masks)


def build_pipeline(
    slow: int = 3,
    fast: int = 3,
    original_hw: tuple[int, int] = (480, 854),
    *,
    num_classes: int = 2,
    dtype: torch.dtype = torch.bfloat16,
    min_size: int | None = None,
    max_size: int | None = None,
    cfg: DetectionConfig | None = None,
    use_slow_fast: bool = True,
    arch: str = "resnet50-fpn",
    vit: ViTConfig | None = None,
    device: str | torch.device | None = None,
    **kw,
) -> tuple[Pipeline, SlowFastMaskRCNN]:
    """Model + pipeline on `device` (default "cuda"; it raises where CUDA is
    absent unless the caller asks for "cpu"). Parameters are float32 and
    compute runs in `dtype`. Weights are torch's default init until the
    caller loads a state dict or calls `init_weights`. `use_slow_fast=False`
    builds the plain per-frame Mask R-CNN (no SlowFast module).
    The image is resized to `min_size` / `max_size`, by default 800 / 1333
    (torchvision's). `arch="vitdet-b"` builds ViTDet-B's backbone and heads
    (`models/vit.py`; `vit`, default ViTDet-B's widths) over a square canvas
    of `vit.image`, the image resized by detectron2's rule to `min_size` /
    `max_size`, by default `vit.image` both."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_pipeline: CUDA is not available; pass device='cpu' to run on the CPU")
    cfg = cfg or DetectionConfig(num_classes=num_classes)
    vit = vit or ViTConfig()
    model = SlowFastMaskRCNN(cfg, SlowFastConfig(slow=slow, fast=fast), dtype, use_slow_fast, arch=arch,
                             vit=vit).to(device)
    square = vit.image if arch == "vitdet-b" else None
    min_size = min_size or square or 800
    max_size = max_size or square or 1333
    transform = ImageTransform(original_hw, min_size=min_size, max_size=max_size, square=square)
    return Pipeline(model, transform, **kw), model


def init_weights(model: SlowFastMaskRCNN, seed: int = 0) -> SlowFastMaskRCNN:
    """Seeded random weights (the JAX package's init distributions)."""
    return lecun_normal_(model, torch.Generator().manual_seed(seed))
