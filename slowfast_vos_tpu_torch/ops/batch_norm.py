"""SlowFast's train-mode BatchNorm: K6, the CUDA kernels and their autograd Function.

Port of flax `nn.BatchNorm(use_running_average=False, momentum=0.9,
epsilon=1e-5, dtype=f32)` as SlowFast's train mode calls it
(`slowfast_vos_tpu/models/slowfast.py:209-214`, `:226-231`; XLA fuses it
there, there is no Pallas kernel), with the ReLU that follows six of its
eight calls fused in. `batch_norm_train_fused(x, bn, relu)` is what
`models/slowfast.py` calls in train mode, on an NCHW clip [T, C, H, W] in
channels-last memory:

* on CUDA tensors it runs `csrc/batch_norm.cu`: `batch_norm_forward_cuda`
  (statistics in f32, the running statistics updated in place on the card,
  normalize with the optional ReLU) and, in the backward,
  `batch_norm_backward_cuda` (the closed form of
  `models/slowfast.py::batch_norm_train_backward_plain`, computing only
  the gradients autograd asks for). Each is one C call of three kernels
  (reduce, finalize, elementwise; see the source's head note): its sums
  are taken in one fixed order, with no atomics, so two calls and a CUDA
  graph's replay agree bit for bit; nothing is read back to the host. Its
  bound on an H100 is bytes: x read and y written in the forward; x and dy
  read and dx written in the backward. Launches are counted in
  `cuda_build.launches`, "bn" per forward call and ("backward", "bn") per
  backward call (recorded by stream, as autograd's device thread launches
  it inside a captured step);
* on CPU tensors it runs the plain versions, `batch_norm_train_plain` and
  `batch_norm_train_backward_plain` (`models/slowfast.py`), through the
  same autograd Function.

There is no fallback between the two: a build or launch that fails raises.
The wrappers raise unless x is channels-last contiguous (what the
convolutions give) and the gradient is channels-last or a channel slice of
one (the backward of SlowFast's channel `cat`s; it goes to the kernel as it
is, with its row stride), so a layout fault is not hidden by a copy. On the
main path every gradient is one of those: the temporal convolutions' frame
slices (`models/slowfast.py::_Frames`) hand back channels-last gradients.

The Function saves x in its own dtype and the [4, C] statistics (mean,
var, invstd, k); the ReLU's mask is recomputed from x with the forward's
own arithmetic, so no f32 copy of x and no copy of y is kept.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

from slowfast_vos_tpu_torch.ops import cuda_build

MAX_PARTIALS = 512  # CTAs of a reduce: each sums its own range of rows
MIN_ROWS_PER_PARTIAL = 64
MAX_C = 1024  # channels a call takes (`csrc/batch_norm.cu::kMaxC`)

# K6's launches under "bn" (forward) and ("backward", "bn"), in the counter
# every kernel wrapper shares.
launches = cuda_build.launches


def partition(rows: int) -> tuple[int, int]:
    """(rows per partial, partials) of a reduce over `rows` rows: at most
    MAX_PARTIALS partials of at least MIN_ROWS_PER_PARTIAL rows. A function
    of the row count alone, so the summation order is too."""
    per = max(MIN_ROWS_PER_PARTIAL, -(-rows // MAX_PARTIALS))
    return per, -(-rows // per)


@functools.cache
def _library() -> ctypes.CDLL:
    """The library of `csrc/batch_norm.cu`, built at first use, its C
    interface declared."""
    lib = cuda_build.load("batch_norm.cu")
    vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sfvos_bn_forward.argtypes = [vp, ci, cl, ci, ci, ci, vp, vp, vp, vp, cf, cf, cf, ci, vp, vp, vp, vp]
    lib.sfvos_bn_forward.restype = ci
    lib.sfvos_bn_backward.argtypes = [vp, cl, vp, ci, cl, ci, ci, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.sfvos_bn_backward.restype = ci
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_x(x: torch.Tensor) -> None:
    """Raise on an x the kernels do not take: [T, C, H, W] float32 or
    bfloat16 on a CUDA device, channels-last contiguous, 16-byte aligned,
    C a multiple of the 16-byte vector and at most MAX_C, at least one row."""
    if x.device.type != "cuda":
        raise ValueError(f"the BatchNorm kernels run on CUDA tensors, not on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the BatchNorm kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"x must be a channels-last contiguous [T, C, H, W] tensor, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    c, vec = x.shape[1], 16 // x.element_size()
    if c % vec or not 0 < c <= MAX_C:
        raise ValueError(f"the BatchNorm kernels take C a multiple of {vec} up to {MAX_C} in {x.dtype}, got {c}")
    if x.numel() == 0:
        raise ValueError("BatchNorm statistics of an empty batch")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def _check_params(x: torch.Tensor, *params: torch.Tensor) -> None:
    c = x.shape[1]
    for p in params:
        if p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"parameters and statistics must be contiguous float32 [{c}] tensors on {x.device}")


def row_stride(dy: torch.Tensor) -> int | None:
    """Elements between rows of dy [T, C, H, W] where it is a channels-last
    tensor or a channel slice of one (rows of C channels, R apart, R a
    multiple of the 16-byte vector, 16-byte aligned), else None."""
    t, c, h, w = dy.shape
    # The row stride, read off the innermost dimension of more than one
    # row; a dimension of size 1 may carry any stride.
    r = dy.stride(3) if w > 1 else dy.stride(2) if h > 1 else dy.stride(0) if t > 1 else c
    vec = 16 // dy.element_size()
    expected = (h * w * r, 1, w * r, r)
    if r < c or r % vec or dy.data_ptr() % 16 or any(
            s != e for s, e, n in zip(dy.stride(), expected, dy.shape) if n > 1):
        return None
    return r


def batch_norm_forward_cuda(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float,
    momentum: float = 0.9,
    relu: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's forward on the card: returns (y in x's dtype, channels-last, the
    ReLU applied where `relu`; the [4, C] f32 statistics mean, var, invstd,
    k) and updates the running statistics in place. One C call, three
    kernels, no host synchronize. Raises on what the kernels do not take
    and on any launch error."""
    _check_x(x)
    _check_params(x, weight, bias, running_mean, running_var)
    t, c, h, w = x.shape
    rows = t * h * w
    per, parts = partition(rows)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    partials = torch.empty((parts, 2, c), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfvos_bn_forward(
            x.data_ptr(), int(x.dtype == torch.bfloat16), rows, c, per, parts, weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), eps, momentum, 1 - momentum, int(relu), y.data_ptr(),
            stats.data_ptr(), partials.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"BatchNorm forward kernel launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
    cuda_build.count_launch("bn", stream)
    return y, stats


def batch_norm_backward_cuda(
    dy: torch.Tensor,
    x: torch.Tensor,
    stats: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    relu: bool = False,
    needs: tuple[bool, bool, bool] = (True, True, True),
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """K6's backward on the card, from the forward's x and statistics:
    (dx in x's dtype, channels-last; dweight; dbias in f32), each None
    where `needs` says so; with `needs[0]` False the elementwise kernel is
    not launched. dy: x's shape and dtype, channels-last or a channel slice
    of a channels-last tensor (`row_stride`). One C call, no host
    synchronize. Raises on what the kernels do not take and on any launch
    error."""
    _check_x(x)
    _check_params(x, weight, bias, stats[0])
    if stats.shape != (4, x.shape[1]) or not stats.is_contiguous():
        raise ValueError(f"stats must be a contiguous float32 [4, {x.shape[1]}] tensor")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x's shape, dtype and device, got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    stride = row_stride(dy)
    if stride is None:
        raise ValueError(f"dy must be channels-last or a channel slice of a channels-last tensor, got strides {dy.stride()}")
    t, c, h, w = x.shape
    rows = t * h * w
    per, parts = partition(rows)
    dx = torch.empty_like(x, memory_format=torch.channels_last) if needs[0] else None
    dweight = torch.empty((c,), dtype=torch.float32, device=x.device) if needs[1] else None
    dbias = torch.empty((c,), dtype=torch.float32, device=x.device) if needs[2] else None
    partials = torch.empty((parts, 2, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((3, c), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfvos_bn_backward(
            dy.data_ptr(), stride, x.data_ptr(), int(x.dtype == torch.bfloat16), rows, c, per, parts,
            stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), int(relu), ptr(dx), ptr(dweight), ptr(dbias),
            partials.data_ptr(), coef.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"BatchNorm backward kernel launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
    cuda_build.count_launch(("backward", "bn"), stream)
    return dx, dweight, dbias


def _plain():
    """`models/slowfast.py`, which holds the plain versions and imports
    this module."""
    from slowfast_vos_tpu_torch.models import slowfast

    return slowfast


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode BN with the optional ReLU, differentiable with respect to
    x, weight and bias: K6 on CUDA tensors, the plain versions on the CPU.
    The running statistics are updated in the forward, in place."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn, momentum, relu):
        if x.device.type == "cuda":
            y, stats = batch_norm_forward_cuda(x, weight, bias, bn.running_mean, bn.running_var, bn.eps, momentum, relu)
        else:
            y, stats = _plain().batch_norm_train_plain(x, bn, momentum, relu)
        ctx.save_for_backward(x, stats, weight, bias)
        ctx.relu = relu
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, stats, weight, bias = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:3])
        if x.device.type == "cuda":
            grads = batch_norm_backward_cuda(dy, x, stats, weight, bias, ctx.relu, needs)
        else:
            grads = _plain().batch_norm_train_backward_plain(dy, x, stats, weight, bias, ctx.relu, needs)
        return (*grads, None, None, None)


def batch_norm_train_fused(x: torch.Tensor, bn: nn.BatchNorm3d, relu: bool = False, momentum: float = 0.9) -> torch.Tensor:
    """flax's train-mode BatchNorm of `models/slowfast.py::batch_norm_train`
    on an NCHW clip [T, C, H, W], then the ReLU where `relu`; the running
    statistics of `bn` updated in place. K6 on CUDA tensors (x must be
    channels-last contiguous), the plain versions on the CPU; there is no
    fallback between the two."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no BatchNorm for device {x.device}")
    return _BatchNormTrain.apply(x, bn.weight, bn.bias, bn, momentum, relu)
