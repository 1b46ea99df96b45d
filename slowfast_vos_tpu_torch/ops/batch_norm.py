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
  the gradients autograd asks for). Each is one cooperative launch of one
  kernel on a persistent grid (see the source's head note): the clip's
  tiles are summed, kept in shared memory as far as `plan` gives them room,
  and normalized after a grid barrier; its sums are taken in one fixed
  order for a given plan, with no atomics, so two calls and a CUDA graph's
  replay agree bit for bit; nothing is read back to the host. Its bound on
  an H100 is bytes: x read and y written in the forward; x and dy read and
  dx written in the backward. Launches are counted in
  `cuda_build.launches`, "bn" per forward call and ("backward", "bn") per
  backward call (recorded by stream, as autograd's device thread launches
  it inside a captured step);
* on CPU tensors it runs the plain versions, `batch_norm_train_plain` and
  `batch_norm_train_backward_plain` (`models/slowfast.py`), through the
  same autograd Function.

There is no fallback between the two: a build, a launch or a cooperative
launch the card refuses raises.
The wrappers raise unless x is channels-last contiguous (what the
convolutions give) and the gradient is channels-last or a channel slice of
one (the backward of SlowFast's channel `cat`s; it goes to the kernel as it
is, with its row stride, as long as a TMA box spans its rows: at most
MAX_BOX_ROW_BYTES), so a layout fault is not hidden by a copy. On the main
path every gradient is one of those: the temporal convolutions' frame
slices (`models/slowfast.py::_Frames`) hand back channels-last gradients,
and SlowFast's BNs have at most 224 channels.

The Function saves x in its own dtype and the [4, C] statistics (mean,
var, invstd, k); the ReLU's mask is recomputed from x with the forward's
own arithmetic, so no f32 copy of x and no copy of y is kept.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
from torch import nn

from slowfast_vos_tpu_torch.ops import cuda_build

MAX_C = 1024  # channels a call takes (`csrc/batch_norm.cu::kMaxC`)
THREADS = 256  # a CTA (`kThreads`); one CTA per SM
SMEM_MAX = 232_448  # dynamic shared memory a CTA may have on sm_90 (`kSmemMax`)
MAX_TILE_ROWS = 256  # rows a tile has at most: a TMA box's height (`kMaxTileRows`)
MAX_SLOTS = 64  # tiles a CTA keeps (`kMaxSlots`)
MAX_BOX_ROW_BYTES = 2048  # a channel-slice dy's row: a TMA box's width (`kMaxBoxRowBytes`)
TILE_BYTES = 16_384  # one tensor's tile, about
MIN_CTA_BYTES = 16_384  # bytes a CTA reads at least, so a small call takes few CTAs

# K6's launches under "bn" (forward) and ("backward", "bn"), in the counter
# every kernel wrapper shares.
launches = cuda_build.launches


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one K6 launch splits a call of `rows` rows (`plan`).

    grid: CTAs, at most one per SM, launched cooperatively; tile_rows:
    rows of a tile, one bulk copy of x (and a TMA box of a channel-slice
    dy); tiles: tiles of the call; slots: tiles a CTA keeps in shared
    memory; smem: the dynamic shared memory a CTA requests
    (`sfvos_bn_smem_bytes`); route: "on-chip" where every CTA's tiles fit
    its slots (x, and dy, read from device memory once), else "stream"
    (the elementwise pass reads the earlier tiles again, most recently
    read first)."""

    grid: int
    tile_rows: int
    tiles: int
    slots: int
    smem: int
    route: str

    def cta_tiles(self, b: int) -> range:
        """The tiles CTA b sums, in its order: b, b + grid, ... (the split
        `csrc/batch_norm.cu::bn_body` takes)."""
        return range(b, self.tiles, self.grid)


def _layout_bytes(c: int, vec: int, tensors: int, tile_bytes: int, slots: int) -> int:
    """`csrc/batch_norm.cu::layout(...).total`: the slots, the lanes' sums
    (or the coefficients, if larger), one mbarrier a slot."""
    lanes = THREADS // (c // vec)
    return slots * tile_bytes * tensors + max(2 * lanes, 3) * c * 4 + slots * 8


@functools.lru_cache(maxsize=None)
def plan(rows: int, c: int, bf16: bool, dy_stride: int | None = None, sm_count: int = 132) -> Plan:
    """K6's launch plan for a call of `rows` rows of C channels: the
    forward's where `dy_stride` is None, else the backward's (x and dy
    share the slots). A function of the shape and the card's SM count
    alone, so the summation order is too, and two calls and a graph's
    replay agree bit for bit.

    A tile is about TILE_BYTES of a whole number of row lanes (THREADS /
    (C / vector) rows a pass), at most MAX_TILE_ROWS rows; the grid takes a
    CTA per MIN_CTA_BYTES read, at most `sm_count`; the tiles are dealt to
    the CTAs in turn (`Plan.cta_tiles`); each CTA keeps as many of its
    tiles as SMEM_MAX holds beside its fixed part, at most MAX_SLOTS."""
    elem = 2 if bf16 else 4
    vec = 16 // elem
    if c % vec or not 0 < c <= MAX_C or rows < 1:
        raise ValueError(f"no K6 plan for {rows} rows of {c} channels in {'bf16' if bf16 else 'f32'}")
    tensors = 1 if dy_stride is None else 2
    lanes = THREADS // (c // vec)
    row_bytes = c * elem
    tile_rows = min(MAX_TILE_ROWS, max(1, TILE_BYTES // row_bytes // lanes) * lanes)
    tile_bytes = -(-row_bytes * tile_rows // 128) * 128
    tiles = -(-rows // tile_rows)
    grid = max(1, min(sm_count, tiles * tile_bytes * tensors // MIN_CTA_BYTES, tiles))
    per_cta = -(-tiles // grid)
    fixed = _layout_bytes(c, vec, tensors, tile_bytes, 0)
    room = (SMEM_MAX - fixed) // (tile_bytes * tensors + 8)
    slots = max(1, min(per_cta, MAX_SLOTS, room))
    return Plan(grid=grid, tile_rows=tile_rows, tiles=tiles, slots=slots,
                smem=_layout_bytes(c, vec, tensors, tile_bytes, slots),
                route="on-chip" if per_cta <= slots else "stream")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of `csrc/batch_norm.cu`."""
    vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sfvos_bn_prepare.argtypes = []
    lib.sfvos_bn_prepare.restype = ci
    lib.sfvos_bn_smem_bytes.argtypes = [ci, ci, ci, ci, ci]
    lib.sfvos_bn_smem_bytes.restype = ci
    lib.sfvos_bn_forward.argtypes = [vp, ci, cl, ci, ci, ci, ci, vp, vp, vp, vp, cf, cf, cf, ci, vp, vp, vp, vp, vp]
    lib.sfvos_bn_forward.restype = ci
    lib.sfvos_bn_backward.argtypes = [vp, cl, vp, ci, cl, ci, ci, ci, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.sfvos_bn_backward.restype = ci
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The library of `csrc/batch_norm.cu`, built at first use, its C
    interface declared."""
    return _bind(cuda_build.load("batch_norm.cu"))


@functools.lru_cache(maxsize=None)
def _prepared(device_index: int) -> ctypes.CDLL:
    """The library, its kernels' shared-memory cap lifted on the device
    (once per device: `sfvos_bn_prepare`)."""
    lib = _library()
    with torch.cuda.device(device_index):
        rc = lib.sfvos_bn_prepare()
    if rc != 0:
        raise RuntimeError(f"BatchNorm kernels refused {SMEM_MAX} B of shared memory: "
                           f"{lib.sfvos_cuda_error_string(rc).decode()}")
    return lib


def _launch_error(lib: ctypes.CDLL, rc: int, what: str) -> RuntimeError:
    """The error of a K6 call that returned `rc`: a cudaError_t (a refused
    launch, e.g. a cooperative grid the card cannot hold at once), or the
    library's own refusals below 0."""
    if rc == -1:
        reason = "the library refused the shape or plan"
    elif rc == -2:
        reason = "cuTensorMapEncodeTiled is not available from the driver"
    elif rc <= -1000:
        reason = f"cuTensorMapEncodeTiled refused dy's tensor map (CUresult {-1000 - rc})"
    else:
        reason = lib.sfvos_cuda_error_string(rc).decode()
    return RuntimeError(f"BatchNorm {what} kernel launch failed: {reason}")


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
    multiple of the 16-byte vector, 16-byte aligned; a slice's rows at most
    MAX_BOX_ROW_BYTES, what one TMA box spans), else None."""
    t, c, h, w = dy.shape
    # The row stride, read off the innermost dimension of more than one
    # row; a dimension of size 1 may carry any stride.
    r = dy.stride(3) if w > 1 else dy.stride(2) if h > 1 else dy.stride(0) if t > 1 else c
    vec = 16 // dy.element_size()
    expected = (h * w * r, 1, w * r, r)
    if r < c or r % vec or dy.data_ptr() % 16 or (r != c and c * dy.element_size() > MAX_BOX_ROW_BYTES) or any(
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
    k) and updates the running statistics in place. One cooperative launch
    of one kernel (`plan`), no host synchronize. Raises on what the kernels
    do not take and on any launch error."""
    _check_x(x)
    _check_params(x, weight, bias, running_mean, running_var)
    t, c, h, w = x.shape
    rows = t * h * w
    p = plan(rows, c, x.dtype == torch.bfloat16, None, _sm_count(x.device.index))
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    partials = torch.empty((p.grid, 2, c), dtype=torch.float64, device=x.device)
    coef = torch.empty((3, c), dtype=torch.float32, device=x.device)
    lib = _prepared(x.device.index)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfvos_bn_forward(
            x.data_ptr(), int(x.dtype == torch.bfloat16), rows, c, p.tile_rows, p.grid, p.slots,
            weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(), eps, momentum,
            1 - momentum, int(relu), y.data_ptr(), stats.data_ptr(), partials.data_ptr(), coef.data_ptr(), stream,
        )
    if rc != 0:
        raise _launch_error(lib, rc, "forward")
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
    where `needs` says so; with `needs[0]` False the kernel stops after the
    sums. dy: x's shape and dtype, channels-last or a channel slice of a
    channels-last tensor (`row_stride`). One cooperative launch of one
    kernel (`plan`), no host synchronize. Raises on what the kernels do not
    take and on any launch error."""
    _check_x(x)
    _check_params(x, weight, bias, stats[0])
    if stats.shape != (4, x.shape[1]) or not stats.is_contiguous():
        raise ValueError(f"stats must be a contiguous float32 [4, {x.shape[1]}] tensor")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x's shape, dtype and device, got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    stride = row_stride(dy)
    if stride is None:
        raise ValueError("dy must be channels-last or a channel slice of a channels-last tensor whose rows are at most "
                         f"{MAX_BOX_ROW_BYTES} bytes, got strides {dy.stride()}")
    t, c, h, w = x.shape
    rows = t * h * w
    p = plan(rows, c, x.dtype == torch.bfloat16, stride, _sm_count(x.device.index))
    dx = torch.empty_like(x, memory_format=torch.channels_last) if needs[0] else None
    dweight = torch.empty((c,), dtype=torch.float32, device=x.device) if needs[1] else None
    dbias = torch.empty((c,), dtype=torch.float32, device=x.device) if needs[2] else None
    partials = torch.empty((p.grid, 2, c), dtype=torch.float64, device=x.device)
    coef = torch.empty((3, c), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _prepared(x.device.index)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfvos_bn_backward(
            dy.data_ptr(), stride, x.data_ptr(), int(x.dtype == torch.bfloat16), rows, c, p.tile_rows, p.grid,
            p.slots, stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), int(relu), ptr(dx),
            ptr(dweight), ptr(dbias), partials.data_ptr(), coef.data_ptr(), stream,
        )
    if rc != 0:
        raise _launch_error(lib, rc, "backward")
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
