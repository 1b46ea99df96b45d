"""slowfast_vos_tpu_torch — the PyTorch/CUDA port of `slowfast_vos_tpu`.

SlowFast Mask R-CNN for an NVIDIA H100: inference, the training step and
the drivers around them (unsupervised training with a DAVIS J&F evaluation
each epoch, OSVOS fine-tuning, the Mask R-CNN fine-tune), with the DAVIS data
layer and scorer, and the parallel layer (`parallel/`: data-parallel
training and process-sharded evaluation over `torch.distributed`, one
process per GPU; device-parallel inference and lockstep OSVOS over a list of
devices in one process). Plain PyTorch modules for the network, plain tensor code
for proposal filtering, NMS, sampling, losses and the mask paste, and
kernels written by hand in CUDA C++ (`csrc/roi_align.cu`) for the
multi-scale RoIAlign that the JAX package ran as a Pallas TPU kernel, and
for its gradient.

The package mirrors the JAX package's layout (`models/`, `ops/`, `train/`,
`data/`, `eval/`, `parallel/`, `utils/`, `convert/`) and keeps its public layout (NHWC
features, XYXY boxes). It imports `torch`, numpy, scipy, Pillow, OpenCV and
the standard library only; nothing of JAX and nothing of `slowfast_vos_tpu`.
"""

__version__ = "0.1.0"
