"""Small constant tensors, built once per value, dtype and device.

`torch.tensor(values, device="cuda")` copies from pageable host memory and
makes the host wait for the card; inside a CUDA graph capture it is an
error. The device paths take their constants from `device_constant`: the
first call builds the tensor, every later call returns that same tensor.
"""
from __future__ import annotations

import functools

import torch


@functools.cache
def device_constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)` (values: a number
    or a tuple), built at the first call with these arguments and shared by
    every later one, so callers must not write to it. Built outside
    inference mode, so autograd may save it for a backward."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
