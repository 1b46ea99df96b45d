"""SlowFast temporal fusion over FPN features, eval mode, whole-clip form.

Port of `slowfast_vos_tpu/models/slowfast.py` (`slowfast.py:180-367`) with
the reference's module names (`slow_fast.fast_conv1`, `slow_fast.bn_f1`,
`slow_fast.conv_f2s1`, ...), so a reference checkpoint loads as it is.

The reference runs two stacks of valid temporal convolutions per frame over
a window (fast = F frames, slow = S centered frames). Valid convolutions are
translation invariant, so running them once over the zero-padded clip is
exactly the per-window computation:

* the clip is padded with F//2 zero frames on the left and ceil(F/2)-1 on
  the right (or arrives `pre_padded` with real or zero halo frames);
* the fast chain reads the padded clip, the slow chain reads the centred
  slice starting at d = F//2 - S//2;
* two fast->slow fusions (with relu) are concatenated into the slow chain;
  stage 3 has no relu;
* after three stages both chains hold one output per frame.

Each (kt, k, k) valid-time conv runs as kt 2-D convolutions summed over the
taps, with the eval BatchNorm (eps 1e-5) folded into its weights in f32.
The JAX module's merged stage-1 convolutions (s == f, and "variant G" for
s != f, `slowfast.py:265-349`) are TPU rewrites and are not carried over:
every pathway runs its own convolutions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.layers import nchw, nhwc


def pathway_kernel_sizes(pathway_size: int) -> tuple[int, int, int]:
    """Three valid temporal kernel sizes that collapse `pathway_size` -> 1
    (reference `_calc_kernel_sizes`)."""
    div, rem = divmod(pathway_size, 3)
    if rem == 0:
        return (div, div + 1, div + 1)
    if rem == 1:
        return (div + 1, div + 1, div + 1)
    return (div + 1, div + 1, div + 2)


def fuse_kernel_size(slow_in: int, slow_kernel: int, fast_in: int, fast_kernel: int):
    """Reference `_calc_fuse_kernel_size`: (kernel, slow out, fast out)."""
    out_slow = slow_in - slow_kernel + 1
    out_fast = fast_in - fast_kernel + 1
    return out_fast - out_slow + 1, out_slow, out_fast


def temporal_conv_bn(x: torch.Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d) -> torch.Tensor:
    """Valid-time conv3d + eval BatchNorm on an NCHW clip [T, Cin, H, W]
    -> [T - kt + 1, Cout, H, W], as kt summed 2-D convs:
    out[t] = sum_i conv2d(x[t + i], w[:, :, i]) + bias, with the BN folded in
    f32 before the cast to the compute dtype."""
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * s
    w = (conv.weight * s[:, None, None, None, None]).to(x.dtype)
    b = shift if conv.bias is None else conv.bias * s + shift
    kt = w.shape[2]
    tout = x.shape[0] - kt + 1
    pad = conv.padding[1:]
    acc = None
    for i in range(kt):
        o = F.conv2d(x[i : i + tout], w[:, :, i], padding=pad)
        acc = o if acc is None else acc + o
    return acc + b.to(x.dtype)[:, None, None]


class SlowFastTemporal(nn.Module):
    """Two-pathway temporal fusion for one FPN level of a whole clip:
    [T, H, W, C] -> [T, H, W, 256] (slow 224 ++ fast 32). One instance is
    shared by P2-P5 (`segmentation.py:60-70`)."""

    def __init__(self, slow: int = 3, fast: int = 3, channels: int = 256, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        assert slow <= fast, "slow pathway must fit inside fast window"
        self.slow, self.fast, self.dtype = slow, fast, dtype
        ks1, ks2, ks3 = pathway_kernel_sizes(slow)
        kf1, kf2, kf3 = pathway_kernel_sizes(fast)
        kfuse1, out_s1, out_f1 = fuse_kernel_size(slow, ks1, fast, kf1)
        kfuse2, _, _ = fuse_kernel_size(out_s1, ks2, out_f1, kf2)

        def conv(cin, cout, kt):
            return nn.Conv3d(cin, cout, (kt, 3, 3), padding=(0, 1, 1))

        def fuse(kt):
            return nn.Conv3d(32, 64, (kt, 1, 1), bias=False)

        self.fast_conv1, self.bn_f1 = conv(channels, 32, kf1), nn.BatchNorm3d(32)
        self.slow_conv1, self.bn_s1 = conv(channels, 192, ks1), nn.BatchNorm3d(192)
        self.conv_f2s1, self.bn_f2s1 = fuse(kfuse1), nn.BatchNorm3d(64)
        self.fast_conv2, self.bn_f2 = conv(32, 32, kf2), nn.BatchNorm3d(32)
        self.slow_conv2, self.bn_s2 = conv(256, 192, ks2), nn.BatchNorm3d(192)
        self.conv_f2s2, self.bn_f2s2 = fuse(kfuse2), nn.BatchNorm3d(64)
        self.fast_conv3, self.bn_f3 = conv(32, 32, kf3), nn.BatchNorm3d(32)
        self.slow_conv3, self.bn_s3 = conv(256, 224, ks3), nn.BatchNorm3d(224)

    def forward(self, feats: torch.Tensor, pre_padded: bool = False) -> torch.Tensor:
        """feats: [T, H, W, C]. With `pre_padded=True` the input already
        carries the F-1 halo frames and the output has T-(F-1) frames."""
        s, f = self.slow, self.fast
        x = nchw(feats.to(self.dtype))
        if pre_padded:
            t = x.shape[0] - (f - 1)
        else:
            t = x.shape[0]
            left, right = f // 2, -(-f // 2) - 1
            zeros = lambda n: x.new_zeros((n, *x.shape[1:])).contiguous(memory_format=torch.channels_last)
            x = torch.cat([zeros(left), x, zeros(right)])
        d = f // 2 - s // 2

        fast_x = x
        slow_x = x[d : d + t + s - 1]
        relu = F.relu
        slow_x = relu(temporal_conv_bn(slow_x, self.slow_conv1, self.bn_s1))
        fast_x = relu(temporal_conv_bn(fast_x, self.fast_conv1, self.bn_f1))
        slow_x = torch.cat([slow_x, relu(temporal_conv_bn(fast_x, self.conv_f2s1, self.bn_f2s1))], dim=1)

        slow_x = relu(temporal_conv_bn(slow_x, self.slow_conv2, self.bn_s2))
        fast_x = relu(temporal_conv_bn(fast_x, self.fast_conv2, self.bn_f2))
        slow_x = torch.cat([slow_x, relu(temporal_conv_bn(fast_x, self.conv_f2s2, self.bn_f2s2))], dim=1)

        # Stage 3: no relu (reference model.py:143-148).
        slow_x = temporal_conv_bn(slow_x, self.slow_conv3, self.bn_s3)
        fast_x = temporal_conv_bn(fast_x, self.fast_conv3, self.bn_f3)
        return nhwc(torch.cat([slow_x, fast_x], dim=1))
