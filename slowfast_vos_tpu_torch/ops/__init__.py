"""Port of `slowfast_vos_tpu.ops`: box math, NMS, RoIAlign (CUDA kernel + plain version), mask paste."""
