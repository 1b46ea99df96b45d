"""Port of `slowfast_vos_tpu.ops`: box math, NMS, RoIAlign (CUDA kernel + plain version), mask paste.

The names the JAX package's `ops` exports, less one: its single-map
`roi_align` function is `ops.roi_align.roi_align` here, because
`ops.roi_align` names the RoIAlign module (kernel wrappers and launch
counts), which a function of the same name would hide."""
from slowfast_vos_tpu_torch.ops.boxes import (  # noqa: F401
    box_area,
    box_iou,
    clip_boxes,
    decode_boxes,
    encode_boxes,
    remove_small_boxes_mask,
)
from slowfast_vos_tpu_torch.ops.nms import batched_nms_mask, nms_mask  # noqa: F401
from slowfast_vos_tpu_torch.ops.paste_masks import paste_masks_in_image  # noqa: F401
from slowfast_vos_tpu_torch.ops.roi_align import multiscale_roi_align  # noqa: F401
