"""SlowFast's train-mode BatchNorm in the port (K6, `ops/batch_norm.py`) on
the CPU, where `batch_norm_train_fused` runs its plain versions
(`models/slowfast.py::batch_norm_train_plain` and
`batch_norm_train_backward_plain`) through the same autograd Function
the card runs the kernels through:

* the closed-form backward against `torch.autograd` through
  `batch_norm_train` (with and without the fused ReLU, for each subset of
  the gradients, a constant channel whose variance clamps to 0): f32,
  within 1e-5 of each tensor's max (two f32 evaluations of one formula,
  in another order);
* the forward and the closed-form backward against `jax.vjp` of flax
  `nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=f32)`, on
  the same numpy inputs, a channel of large mean and small spread
  included: rel 1e-4 (two libraries' f32 sums, whose order differs,
  through the cancellation E[x^2] - E[x]^2, ~16x here);
* `SlowFastTemporal` in train mode on `test_torch_models.py`'s train-mode
  set-up: the fused path against the unfused one it replaced
  (`batch_norm_train` and a separate ReLU), outputs and running statistics
  bit for bit, gradients within 1e-5 of each tensor's max; and every BN
  input channels-last contiguous, as the card's kernels demand;
* K6's launch plan (`plan`: every row once, in a fixed order, within the
  shared-memory cap, each of a full-width step's 32 calls on its route),
  the wrappers' shape functions and refusals.

The kernels themselves are held against these plain versions on the card:
`tests/test_torch_cuda.py -k batch_norm` and `chip_smoke.py` phase 13."""
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_common import noisy_variables, rel_err, t
from slowfast_vos_tpu.models.slowfast import SlowFastTemporal as JaxSlowFast
from slowfast_vos_tpu_torch.convert.from_flax import slow_fast_state_dict
from slowfast_vos_tpu_torch.models import slowfast as psf
from slowfast_vos_tpu_torch.ops import batch_norm as pbn

CLOSED_FORM_RTOL = 1e-5
JAX_RTOL = 1e-4
SHAPE = (3, 5, 7)  # T, H, W: 105 rows


def bn_inputs(c, seed, constant=0.1, large_mean=False):
    """numpy x and dy [T, C, H, W] (per-channel means U(-1, 1), spreads
    U(0.5, 2)); channel 0 constant at `constant`, or, where `constant` is
    None, of mean 100 and spread 1e-3 (E[x^2] - E[x]^2 is then rounding
    noise of either sign while (x - mean) * invstd is O(1)); channel 1 of
    mean 4 and spread 0.25 where `large_mean`; weight, bias and running
    statistics [C]."""
    rng = np.random.default_rng(seed)
    tt, h, w = SHAPE
    x = rng.uniform(-1, 1, c)[:, None, None] + rng.uniform(0.5, 2, c)[:, None, None] * rng.standard_normal((tt, c, h, w))
    x[:, 0] = 100 + 1e-3 * rng.standard_normal((tt, h, w)) if constant is None else constant
    if large_mean:
        x[:, 1] = 4 + 0.25 * rng.standard_normal((tt, h, w))
    params = [rng.uniform(lo, hi, c) for lo, hi in ((0.5, 1.5), (-0.5, 0.5), (-1, 1), (0.5, 2))]
    return [a.astype(np.float32) for a in (x, rng.standard_normal(x.shape), *params)]


def torch_bn(weight, bias, mean, var):
    bn = torch.nn.BatchNorm3d(len(weight))
    with torch.no_grad():
        for p, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), (weight, bias, mean, var)):
            p.copy_(t(v))
    return bn


def channels_last(a):
    return t(a).contiguous(memory_format=torch.channels_last)


def autograd_reference(x, dy, bn, relu, needs):
    """The forward `batch_norm_train` (then `F.relu`) differentiated by
    autograd: (y, dx, dweight, dbias), None where not needed."""
    x = x.clone().requires_grad_(needs[0])
    bn.weight.requires_grad_(needs[1])
    bn.bias.requires_grad_(needs[2])
    y = psf.batch_norm_train(x, bn)
    y = F.relu(y) if relu else y
    wanted = [v for v, n in zip((x, bn.weight, bn.bias), needs) if n]
    grads = iter(torch.autograd.grad(y, wanted, dy))
    return y.detach(), *[next(grads) if n else None for n in needs]


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False), (False, True, True), (False, True, False)])
@pytest.mark.parametrize("relu", [False, True])
def test_closed_form_backward_matches_autograd(relu, needs):
    """`batch_norm_fused`'s CPU path (forward, then the closed-form backward)
    against autograd through `batch_norm_train`: y and the running
    statistics bit for bit (the same forward), each asked-for gradient
    within 1e-5 of its max, the others None. Channel 0 is nearly constant
    at 100: there E[x^2] - E[x]^2 rounds below 0 and the clamp holds var at
    0 while (x - mean) * invstd stays O(1), so the closed form must drop
    the variance's term there as autograd does."""
    x, dy, *params = bn_inputs(32, seed=0, constant=None)
    x, dy = channels_last(x), channels_last(dy)
    ref_bn, bn = torch_bn(*params), torch_bn(*params)
    stats = psf.batch_norm_statistics(x, bn.eps)
    assert float(stats[3, 0]) == 0.0 and bool((stats[3, 1:] == 1).all()), "channel 0's clamp must hold"
    assert float(((x[:, 0] - stats[0, 0]) * stats[2, 0]).abs().max()) > 0.1
    want = autograd_reference(x, dy, ref_bn, relu, needs)
    xin = x.clone().requires_grad_(needs[0])
    bn.weight.requires_grad_(needs[1])
    bn.bias.requires_grad_(needs[2])
    y = pbn.batch_norm_train_fused(xin, bn, relu=relu)
    assert torch.equal(y.detach(), want[0])
    assert torch.equal(bn.running_mean, ref_bn.running_mean) and torch.equal(bn.running_var, ref_bn.running_var)
    y.backward(dy)
    for got, ref in zip((xin.grad, bn.weight.grad, bn.bias.grad), want[1:]):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert rel_err(got, ref) <= CLOSED_FORM_RTOL


@pytest.mark.parametrize("constant", [0.1, 0.75])
def test_plain_backward_matches_autograd_on_constant_channels(constant):
    """`batch_norm_train_backward_plain` called directly, on a constant
    channel whose E[x^2] - E[x]^2 is rounding noise (0.1) or exactly 0
    (0.75, where the clamp passes its gradient; (x - mean) is 0 in both),
    with the ReLU: against autograd within 1e-5 of each tensor's max."""
    x, dy, *params = bn_inputs(16, seed=2, constant=constant)
    x, dy = channels_last(x), channels_last(dy)
    bn = torch_bn(*params)
    want = autograd_reference(x, dy, copy.deepcopy(bn), True, (True, True, True))
    _, stats = psf.batch_norm_train_plain(x, bn, relu=True)
    got = psf.batch_norm_train_backward_plain(dy, x, stats, bn.weight.detach(), bn.bias.detach(), relu=True)
    for g, w in zip(got, want[1:]):
        assert rel_err(g, w) <= CLOSED_FORM_RTOL


def flax_bn_vjp(x, dy, weight, bias, mean, var, relu):
    """flax `nn.BatchNorm(use_running_average=False, momentum=0.9,
    epsilon=1e-5, dtype=f32)` (then `nn.relu`) on x [T, C, H, W] as NHWC:
    (y, new mean, new var, dx, dweight, dbias), x and dx as [T, C, H, W]."""
    module = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(xs, params):
        y, upd = module.apply({"params": params, "batch_stats": stats}, xs, mutable=["batch_stats"])
        return (fnn.relu(y) if relu else y), upd["batch_stats"]

    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    y, vjp, upd = jax.vjp(f, nhwc(x), params, has_aux=True)
    dx, dparams = vjp(nhwc(dy))
    back = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return back(y), np.asarray(upd["mean"]), np.asarray(upd["var"]), back(dx), np.asarray(dparams["scale"]), np.asarray(
        dparams["bias"])


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [32, 64])
def test_fused_batch_norm_matches_flax(c, relu):
    """The CPU path of `batch_norm_train_fused`, forward and backward,
    against `jax.vjp` of flax's BatchNorm (and ReLU) on the same numpy
    inputs: y, the running statistics, dx, dweight and dbias, each to rel
    1e-4 of its max. Channel 0 is constant 0.75 (var exactly 0), channel 1
    has mean 4 and spread 0.25."""
    x, dy, *params = bn_inputs(c, seed=3 + c, constant=0.75, large_mean=True)
    want = flax_bn_vjp(x, dy, *params, relu)
    bn = torch_bn(*params)
    xin = channels_last(x).requires_grad_(True)
    y = pbn.batch_norm_train_fused(xin, bn, relu=relu)
    y.backward(channels_last(dy))
    got = (y.detach(), bn.running_mean, bn.running_var, xin.grad, bn.weight.grad, bn.bias.grad)
    for name, g, w in zip(("y", "mean", "var", "dx", "dweight", "dbias"), got, want):
        assert rel_err(g.detach(), w) <= JAX_RTOL, name


def slowfast_module(slow, fast, c=16):
    """`test_torch_models.py::_slowfast_pair`'s port module (the JAX
    module's noisy variables, carried over) in train mode."""
    jmod = JaxSlowFast(slow=slow, fast=fast, channels=c, dtype=jnp.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((fast, 4, 4, c)))
    variables = noisy_variables(shapes, seed=slow * 10 + fast)
    pmod = psf.SlowFastTemporal(slow, fast, channels=c, dtype=torch.float32)
    pmod.load_state_dict(slow_fast_state_dict(variables["params"], variables["batch_stats"]), strict=True)
    return pmod.train()


def unfused_conv_bn(self, x, conv, bn, relu=False):
    """The train-mode `conv_bn` the fused path replaced: `batch_norm_train`
    under autograd, then a separate ReLU."""
    y = psf.batch_norm_train(psf.temporal_conv(x, conv.weight, conv.bias, conv.padding[1:]), bn)
    return F.relu(y) if relu else y


@pytest.mark.parametrize("slow,fast", [(1, 7), (3, 3)])
def test_slowfast_train_mode_fused_equals_unfused(slow, fast, monkeypatch):
    """`SlowFastTemporal` in train mode on `test_slowfast_train_mode_matches_flax`'s
    set-up (a pre-padded 4-frame window, 6x8, 16 channels): through
    `batch_norm_train_fused` (ReLU fused) against the unfused path, from
    the same weights and statistics: outputs and running statistics bit
    for bit; the gradients of the input and of every parameter within
    1e-5 of each tensor's max, except the convolutions' biases, whose
    gradient is 0 in exact arithmetic (a BN follows each): those within
    1e-5 of the largest SlowFast gradient. Every tensor reaching the
    fused function is channels-last contiguous, as the card's kernels
    demand, and every gradient reaching one is channels-last or a channel
    slice of a channels-last tensor (`row_stride`), as the card's backward
    demands."""
    tt, h, w = 4, 6, 8
    feats = np.random.default_rng(6).normal(size=(tt + fast - 1, h, w, 16)).astype(np.float32)
    dy = np.random.default_rng(7).normal(size=(tt, h, w, 256)).astype(np.float32)
    runs, layouts = {}, []
    fused = pbn.batch_norm_train_fused

    def spy(x, bn, relu=False, momentum=0.9):
        layouts.append(x.is_contiguous(memory_format=torch.channels_last))
        y = fused(x, bn, relu, momentum)
        y.register_hook(lambda g: layouts.append(pbn.row_stride(g) is not None))
        return y

    for name in ("unfused", "fused"):
        pmod = slowfast_module(slow, fast)
        with monkeypatch.context() as m:
            if name == "unfused":
                m.setattr(psf.SlowFastTemporal, "conv_bn", unfused_conv_bn)
            else:
                m.setattr(pbn, "batch_norm_train_fused", spy)
            x = t(feats).requires_grad_(True)
            out = pmod(x, pre_padded=True)
            out.backward(t(dy))
        runs[name] = (out.detach(), pmod.state_dict(), x.grad, {k: p.grad for k, p in pmod.named_parameters()})
    assert layouts == [True] * 16
    (out, state, gx, grads), (fout, fstate, fgx, fgrads) = runs["unfused"], runs["fused"]
    assert torch.equal(fout, out)
    assert all(torch.equal(fstate[k], v) for k, v in state.items())
    assert rel_err(fgx, gx) <= CLOSED_FORM_RTOL
    largest = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        if "conv" in k and k.endswith(".bias"):
            assert float((fgrads[k] - g).abs().max()) <= 1e-5 * largest, k
        else:
            assert rel_err(fgrads[k], g) <= CLOSED_FORM_RTOL, k


PLAN_CASES = [  # (rows, C, bf16): tiny, ragged, a full-width step's largest, f32, C above 256
    (1, 32, True), (63, 64, True), (3219, 192, True), (67334, 224, True), (258048, 192, True),
    (10**7, 32, True), (105, 32, False), (3219, 224, False), (5000, 1024, False), (777, 264, True)]


@pytest.mark.parametrize("rows,c,bf16", PLAN_CASES)
def test_partition_covers_rows_in_bounded_partials(rows, c, bf16):
    """`plan`, forward and backward: every row in exactly one tile of
    exactly one CTA, a CTA's tiles dealt in turn (b, b + grid, ...: the
    order its partial sums them in), at most one CTA per SM and no more
    CTAs than tiles, the tiles as even as integers allow (counts differ by
    at most one), a tile at most MAX_TILE_ROWS rows, 1-64 slots, the route
    "on-chip" exactly where each CTA's tiles fit its slots."""
    for dy_stride in (None, c):
        p = pbn.plan(rows, c, bf16, dy_stride, 132)
        assert 1 <= p.grid <= min(132, p.tiles)
        assert 1 <= p.tile_rows <= pbn.MAX_TILE_ROWS and p.tiles == -(-rows // p.tile_rows)
        owned = [list(p.cta_tiles(b)) for b in range(p.grid)]
        assert sorted(t for ts in owned for t in ts) == list(range(p.tiles))
        assert (p.tiles - 1) * p.tile_rows < rows <= p.tiles * p.tile_rows  # tile t: rows [t R, min(N, (t + 1) R))
        counts = [len(ts) for ts in owned]
        assert min(counts) >= 1 and max(counts) - min(counts) <= 1
        assert 1 <= p.slots <= min(pbn.MAX_SLOTS, max(counts))
        assert p.route == ("on-chip" if max(counts) <= p.slots else "stream")


@pytest.mark.parametrize("rows,c,bf16", PLAN_CASES)
def test_plan_requests_at_most_the_shared_memory_cap(rows, c, bf16):
    """A CTA requests at most 232,448 B of dynamic shared memory (sm_90's
    cap), counted as `csrc/batch_norm.cu::layout` counts it: the slots (x,
    and dy in the backward), the lanes' f32 sums (room for the [3, C]
    coefficients, where that is more), one 8-byte mbarrier a slot; a
    stream-route plan fills the cap as far as whole slots go."""
    for dy_stride in (None, c):
        p = pbn.plan(rows, c, bf16, dy_stride, 132)
        tensors = 1 if dy_stride is None else 2
        elem = 2 if bf16 else 4
        tile = -(-c * elem * p.tile_rows // 128) * 128
        lanes = 256 // (c * elem // 16)
        fixed = max(2 * lanes, 3) * c * 4
        assert p.smem == p.slots * (tile * tensors + 8) + fixed
        assert p.smem <= 232_448
        if p.route == "stream" and p.slots < pbn.MAX_SLOTS:
            assert p.smem + tile * tensors + 8 > 232_448


def test_plan_is_a_function_of_its_inputs():
    """The same inputs give the same plan, also computed afresh; another
    SM count or direction may give another."""
    cases = [(rows, c, bf16, d) for rows, c, bf16 in PLAN_CASES for d in (None, c)]
    first = [pbn.plan(*k, 132) for k in cases]
    pbn.plan.cache_clear()
    assert [pbn.plan(*k, 132) for k in cases] == first
    assert pbn.plan(258048, 192, True, None, 132) != pbn.plan(258048, 192, True, None, 114)


# A full-width training step's 32 K6 calls (SlowFast 3-3 on the FPN of a
# 768x1344 canvas, bf16): (name, C, T) at P2-P5, and the route each
# direction's plan gives it on a 132-SM H100. Forward: a CTA keeps 13 tiles
# of ~15-16 KB (about 26 MB over the grid), so the four P2 calls above that
# stream; backward: x and dy share the slots (6 tiles of each, about 12 MB
# a tensor), so P2's calls from 16.5 MB up and P3's three 192/224-channel
# calls stream too.
STEP_BNS = (("bn_s1", 192, 4), ("bn_f1", 32, 4), ("bn_f2s1", 64, 4), ("bn_s2", 192, 3),
            ("bn_f2", 32, 3), ("bn_f2s2", 64, 3), ("bn_s3", 224, 2), ("bn_f3", 32, 2))
STEP_LEVELS = {"P2": (192, 336), "P3": (96, 168), "P4": (48, 84), "P5": (24, 42)}
STREAM_FORWARD = {("P2", n) for n in ("bn_s1", "bn_f2s1", "bn_s2", "bn_s3")}
STREAM_BACKWARD = STREAM_FORWARD | {("P2", "bn_f1"), ("P2", "bn_f2s2"), ("P3", "bn_s1"), ("P3", "bn_s2"),
                                    ("P3", "bn_s3")}


@pytest.mark.parametrize("level", list(STEP_LEVELS))
@pytest.mark.parametrize("name,c,frames", STEP_BNS)
def test_plan_routes_of_a_full_width_step(level, name, c, frames):
    """Each of the step's 32 calls gets its expected route each way with
    sm_count=132: on-chip (x, and dy, read from device memory once), or
    stream (the elementwise pass reads the earlier tiles again, most
    recently read first)."""
    h, w = STEP_LEVELS[level]
    rows = frames * h * w
    fwd, bwd = pbn.plan(rows, c, True, None, 132), pbn.plan(rows, c, True, c, 132)
    assert fwd.route == ("stream" if (level, name) in STREAM_FORWARD else "on-chip")
    assert bwd.route == ("stream" if (level, name) in STREAM_BACKWARD else "on-chip")
    assert max(fwd.smem, bwd.smem) <= 232_448


def test_row_stride_reads_channels_last_rows_and_channel_slices():
    """`row_stride`: C for a channels-last tensor, the parent's C for a
    channel slice of one, None for NCHW, a channel stride other than 1, an
    expanded tensor, rows that are not 16-byte vectors or a slice of rows
    wider than a TMA box spans (MAX_BOX_ROW_BYTES: f32 C 520 is 2080 bytes,
    bf16 C 520 fits); size-1 dimensions of any stride are accepted."""
    x = torch.randn(2, 64, 5, 7).contiguous(memory_format=torch.channels_last)
    wide = torch.randn(2, 256, 5, 7).contiguous(memory_format=torch.channels_last)
    assert pbn.row_stride(x) == 64
    assert pbn.row_stride(wide[:, 192:]) == 256 and pbn.row_stride(wide[:, :32]) == 256
    assert pbn.row_stride(x.contiguous()) is None
    assert pbn.row_stride(wide[:, ::2]) is None
    assert pbn.row_stride(torch.ones(()).expand(2, 64, 5, 7)) is None
    assert pbn.row_stride(wide[:, 3:35]) is None  # rows 12 bytes off a 16-byte boundary
    one_row = torch.randn(1, 64, 1, 1)
    assert pbn.row_stride(one_row) == 64
    wider = torch.randn(2, 528, 3, 5).contiguous(memory_format=torch.channels_last)
    assert 520 * 4 > pbn.MAX_BOX_ROW_BYTES >= 520 * 2
    assert pbn.row_stride(wider[:, 8:]) is None
    assert pbn.row_stride(wider.to(torch.bfloat16)[:, 8:]) == 528
    assert pbn.row_stride(wider[:, 8:].contiguous(memory_format=torch.channels_last)) == 520



def test_kernel_wrappers_refuse_cpu_tensors_and_other_devices():
    """The CUDA wrappers run on CUDA tensors only (the CPU path goes
    through the plain versions, not through them), and the fused function
    refuses devices other than CUDA and CPU; nothing is counted."""
    x, dy, *params = bn_inputs(32, seed=4)
    x = channels_last(x)
    bn = torch_bn(*params)
    before = dict(pbn.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pbn.batch_norm_forward_cuda(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    stats = psf.batch_norm_statistics(x, bn.eps)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pbn.batch_norm_backward_cuda(channels_last(dy), x, stats, bn.weight, bn.bias)
    with pytest.raises(ValueError, match="no BatchNorm for device"):
        pbn.batch_norm_train_fused(x.to("meta"), bn)
    pbn.batch_norm_train_fused(x, bn, relu=True).sum().backward()
    assert dict(pbn.launches) == before
