"""slowfast_vos_tpu_torch — the PyTorch/CUDA port of `slowfast_vos_tpu`.

SlowFast Mask R-CNN inference and its training step for an NVIDIA H100:
plain PyTorch modules for the network, plain tensor code for proposal
filtering, NMS, sampling, losses and the mask paste, and kernels written by
hand in CUDA C++ (`csrc/roi_align.cu`) for the multi-scale RoIAlign that the
JAX package ran as a Pallas TPU kernel, and for its gradient.

The package mirrors the JAX package's layout (`models/`, `ops/`, `train/`,
`data/`, `convert/`) and keeps its public layout (NHWC features, XYXY boxes). It
imports `torch`, numpy and the standard library only; nothing of JAX and
nothing of `slowfast_vos_tpu`.
"""

__version__ = "0.1.0"
