"""The epilogue of a backbone convolution (K8): bias, residual, ReLU in one pass.

K8 replaces no TPU kernel: XLA fuses the ResNet-50's frozen BatchNorms,
residual adds and ReLUs into its convolutions. The port folds each frozen
BatchNorm's scale into its convolution's weights
(`models/resnet_fpn.py`); what is left after the convolution is

    y = act(x + bias[c] (+ residual)),   act = identity or ReLU,

on x [N, C, H, W] in channels-last memory, computed in float32 and
rounded once to x's dtype. `csrc/conv_epilogue.cu` does it in one pass of
16-byte vectors (see its head note); its bound on an H100 is bytes: x
read, the residual read, y written, at 3.35 TB/s.

`conv_epilogue` launches K8 on CUDA tensors (counted in
`ops/cuda_build.py::launches` under "epilogue") and takes the plain version
on CPU tensors. Where autograd records (grad mode on and an input that
requires grad: the backbone layers that OSVOS and the Mask R-CNN fine-tune
train), K8 runs inside `_Epilogue`, an autograd Function whose backward is
plain PyTorch; otherwise it writes y over x in place. The wrapper raises on
a CUDA tensor that is not channels-last contiguous, of another dtype than
bfloat16 or float32, or whose C is not a multiple of 8: nothing is copied.
The kernel is built by `ops/cuda_build.py` at the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from slowfast_vos_tpu_torch.ops import cuda_build
from slowfast_vos_tpu_torch.ops.cuda_build import count_launch, launches  # noqa: F401 (launches: the counts, by key)

DTYPES = (torch.bfloat16, torch.float32)
MAX_C = 12288  # the bias in 48 KB of shared memory (`csrc/conv_epilogue.cu::kMaxC`)


def conv_epilogue_plain(x: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None,
                        relu: bool = False) -> torch.Tensor:
    """The plain version: act(x + bias (+ residual)) in float32 (float64 for
    float64 x), rounded once to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.to(acc) + bias.to(acc)[:, None, None]
    if residual is not None:
        y = y + residual.to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x, bias, residual):
    if x.dtype not in DTYPES:
        raise ValueError(f"K8 takes {DTYPES}, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"K8 takes a channels-last contiguous [N, C, H, W] tensor, not {tuple(x.shape)} "
                         f"at strides {x.stride()}")
    c = x.shape[1]
    if c % 8 != 0 or c > MAX_C:
        raise ValueError(f"K8 takes C a multiple of 8 up to {MAX_C}, not {c}")
    if bias.shape != (c,) or bias.dtype != torch.float32 or bias.device != x.device or bias.stride() != (1,):
        raise ValueError(f"K8 takes a contiguous float32 bias of [{c}] on {x.device}, not {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"the residual {tuple(residual.shape)} {residual.dtype} is not channels-last like x "
                         f"{tuple(x.shape)} {x.dtype}")
    if any(t is not None and t.data_ptr() % 16 for t in (x, residual)):
        raise ValueError("K8 takes tensors that start on 16 bytes")


@functools.cache
def _library() -> ctypes.CDLL:
    """The library of `csrc/conv_epilogue.cu`, built at first use, its C
    interface declared."""
    lib = cuda_build.load("conv_epilogue.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sfvos_k8_conv_epilogue.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp]
    lib.sfvos_k8_conv_epilogue.restype = ci
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p
    return lib


def conv_epilogue_cuda(x: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None,
                       relu: bool = False, inplace: bool = False) -> torch.Tensor:
    """K8 on CUDA tensors, into a new tensor like x, or over x where
    `inplace`. Records nothing for autograd."""
    if x.device.type != "cuda":
        raise ValueError("conv_epilogue_cuda takes CUDA tensors")
    _check(x, bias, residual)
    out = x if inplace else torch.empty_like(x, memory_format=torch.channels_last)
    n, c, h, w = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sfvos_k8_conv_epilogue(x.data_ptr(), bias.data_ptr(), None if residual is None else residual.data_ptr(),
                                        out.data_ptr(), n * h * w, c, int(x.dtype == torch.bfloat16), int(relu), stream)
    if rc != 0:
        raise RuntimeError(f"K8 launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
    count_launch("epilogue", stream)
    return out


class _Epilogue(torch.autograd.Function):
    """K8 forward, plain backward: g' = g where y > 0 (ReLU), else g; the
    gradients of x and of the residual are g', the bias's g' summed over
    N, H, W in float32."""

    @staticmethod
    def forward(ctx, x, bias, residual, relu):
        y = conv_epilogue_cuda(x, bias, residual, relu)
        ctx.relu, ctx.has_residual = relu, residual is not None
        ctx.save_for_backward(y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.relu:
            (y,) = ctx.saved_tensors
            g = g * (y > 0)
        d_bias = g.sum((0, 2, 3), dtype=torch.float32) if ctx.needs_input_grad[1] else None
        return g, d_bias, (g if ctx.has_residual else None), None


def conv_epilogue(x: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None = None,
                  relu: bool = False) -> torch.Tensor:
    """act(x + bias (+ residual)): K8 on CUDA tensors, the plain version on
    the CPU; see the module. Without autograd recording, K8 writes over x."""
    if x.device.type != "cuda":
        return conv_epilogue_plain(x, bias, residual, relu)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, bias, residual)):
        return _Epilogue.apply(x, bias, residual, relu)
    return conv_epilogue_cuda(x, bias, residual, relu, inplace=True)
