"""slowfast_vos_tpu_torch — the PyTorch/CUDA port of `slowfast_vos_tpu`.

SlowFast Mask R-CNN inference for an NVIDIA H100: plain PyTorch modules for
the network, plain tensor code for proposal filtering, NMS and the mask
paste, and one kernel written by hand in CUDA C++ (`csrc/roi_align.cu`) for
the multi-scale RoIAlign that the JAX package ran as a Pallas TPU kernel.

The package mirrors the JAX package's layout (`models/`, `ops/`,
`convert/`) and keeps its public layout (NHWC features, XYXY boxes). It
imports `torch`, numpy and the standard library only; nothing of JAX and
nothing of `slowfast_vos_tpu`.
"""

__version__ = "0.1.0"
