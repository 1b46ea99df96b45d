"""The port's superchunk on its way to a CUDA graph, on the CPU at the
`__graft_entry__` size (120x200 frames, min 128, max 256, superchunk 4,
SlowFast 3-3, f32): the windows staged in page-locked host memory are the
windows `chunk_inputs` made before; the constants cached once per device
give the outputs the per-call constants gave, bit for bit; a superchunk
builds no tensor from host data; graphs are refused off the card; the
weight bookkeeping of `models/graphs.py` drops its graphs when a parameter
or buffer moves and keeps them across in-place updates; kernel launches
recorded at capture count per replay; and `infer_sequence` still matches
the JAX package's across a carry chunk (the slice's tolerances,
tests/test_torch_pipeline.py). The graphs themselves run only on the card:
tests/test_torch_cuda.py holds them against the eager path there."""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import HW, SC, assert_detections_close, port_pipeline
from torch_port_common import noisy_variables
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu_torch.models import graphs, pipeline, transform
from slowfast_vos_tpu_torch.models.pipeline import Pipeline, build_pipeline
from slowfast_vos_tpu_torch.ops import cuda_build, roi_align

T = 10  # chunks at 0 (first), 4 (carry) and 8 (carry, two frames past the end)


def clip(dtype=np.uint8, seed=3, t=T, hw=HW):
    frames = np.random.default_rng(seed).integers(0, 256, (t, *hw, 3), dtype=np.uint8)
    return frames if dtype == np.uint8 else (frames / 255.0).astype(dtype)


def window_before(pipe, images, c, carried):
    """`chunk_inputs`' window and feat_valid as numpy, as it computed them
    before the staging (a fancy-indexed copy, zeroed outside [0, T))."""
    t = images.shape[0]
    widxs = np.arange(c - pipe.halo_left, c + pipe.superchunk + pipe.halo_right)
    idxs = widxs[pipe.sf.fast - 1:] if carried else widxs
    window = images[np.clip(idxs, 0, t - 1)].copy()
    window[~((idxs >= 0) & (idxs < t))] = 0
    return window, (widxs >= 0) & (widxs < t)


# (T, frame size, chunk start, carried), SC = 4 and F = 3: the first, a carry
# and the last (partly out-of-range) chunk of T = 10; a clip shorter than one
# window, one of exactly one superchunk, and a one-frame carry chunk; the
# first three at an odd frame size.
CHUNKS = {
    "first": (T, HW, 0, False),
    "carry": (T, HW, 4, True),
    "last": (T, HW, 8, True),
    "short_clip": (2, HW, 0, False),
    "one_superchunk": (4, HW, 0, False),
    "one_frame_carry": (5, HW, 4, True),
    "odd_first": (T, (61, 101), 0, False),
    "odd_carry": (T, (61, 101), 4, True),
    "odd_last": (T, (61, 101), 8, True),
}


@pytest.fixture(scope="module")
def staging_pipe():
    return port_pipeline(seed=0)


@pytest.mark.parametrize("t,hw,c,carried", CHUNKS.values(), ids=CHUNKS.keys())
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_staged_chunk_inputs_equal_the_window_before(staging_pipe, dtype, t, hw, c, carried):
    """The window staged into host buffers (page-locked on the card) and
    feat_valid: equal to the window as `chunk_inputs` made it before."""
    images = clip(dtype, t=t, hw=hw)
    want, want_valid = window_before(staging_pipe, images, c, carried)
    got, got_valid = staging_pipe.chunk_inputs(images, c, carried)
    assert got.dtype == torch.from_numpy(want).dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)


def _fresh_constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


# Every constant of the superchunk in two runs: the packed union (packbits'
# bit weights) and instance masks; both normalize the frames (mean and std),
# invert boxes and pool through the plain RoIAlign.
PATHS = [False, True]


@pytest.mark.parametrize("instance_masks", PATHS)
def test_cached_constants_give_the_outputs_bit_for_bit(monkeypatch, instance_masks):
    """Mean and std, the inverse-box scale, the bit weights and the plain
    RoIAlign's level tables, built once per device, against the same
    constants built at every call (as before), over a first and a ragged
    carry chunk."""
    pipe = port_pipeline(seed=2)
    images = clip(t=6)
    cached = pipe.infer_sequence(images, instance_masks=instance_masks)
    for module in (transform, pipeline, roi_align):
        monkeypatch.setattr(module, "device_constant", _fresh_constant)
    fresh = pipe.infer_sequence(images, instance_masks=instance_masks)
    assert len(cached) == len(fresh) == 6
    assert any(d["valid"].any() for d in cached)
    for a, b in zip(cached, fresh):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_superchunk_builds_no_tensor_from_host_data(monkeypatch):
    """Once its constants exist, a superchunk (first and carried, both
    finalize forms) calls neither `torch.tensor` nor
    `torch.as_tensor`: on the card each would be a copy from pageable host
    memory and a host synchronize, and an error inside a graph capture."""
    pipe = port_pipeline(seed=0)
    images = clip(t=6)

    def superchunks(masks, starts):
        carry = None
        for c in starts:
            dev_images, dev_valid = pipe.chunk_inputs(images, c, carry is not None)
            with torch.inference_mode():
                outs, carry = pipe._superchunk(dev_images, dev_valid, carry, masks)
            assert outs[0].shape[0] == SC

    for masks in PATHS:  # warm: the constants of every path
        superchunks(masks, [0])
    calls = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw))
    for masks in PATHS:
        superchunks(masks, [0, SC])
    assert calls == []


def test_graphs_are_refused_off_the_card():
    pipe = port_pipeline(seed=0)
    assert pipe.graphs is None  # the default on the CPU: eager
    with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
        Pipeline(pipe.model, pipe.transform, superchunk=SC, graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs run on a CUDA device"):
        build_pipeline(3, 3, HW, min_size=128, max_size=256, dtype=torch.float32, device="cpu", graphs=True)
    assert Pipeline(pipe.model, pipe.transform, superchunk=SC, graphs=False).graphs is None


def test_graphs_are_dropped_when_a_weight_moves_and_kept_across_in_place_updates():
    """The runner's bookkeeping on the CPU (no capture): in-place updates
    keep the graphs, a moved parameter or buffer drops them all, train mode
    raises."""
    pipe = port_pipeline(seed=0)
    model = pipe.model
    runner = graphs.SuperchunkGraphs(pipe)
    runner.check_model()

    def captured():
        runner.graphs[("key",)] = "graph"
        runner.check_model()
        return ("key",) in runner.graphs

    assert captured()
    state = {k: v.clone() + 1 for k, v in model.state_dict().items()}
    model.load_state_dict(state)  # copies in place
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # an optimizer step
    model.slow_fast.bn_s1.running_mean.mul_(0.9)  # a running-statistics update
    runner.check_model()
    assert ("key",) in runner.graphs

    model.load_state_dict(state, assign=True)  # every tensor replaced
    runner.check_model()
    assert runner.graphs == {}

    assert captured()
    model.roi_heads.box_predictor.cls_score.weight = torch.nn.Parameter(model.roi_heads.box_predictor.cls_score.weight.clone())
    runner.check_model()
    assert runner.graphs == {}

    assert captured()
    model.slow_fast.bn_f1.running_var = model.slow_fast.bn_f1.running_var.clone()  # a buffer replaced
    runner.check_model()
    assert runner.graphs == {}

    model.train()
    with pytest.raises(RuntimeError, match="eval mode"):
        runner.check_model()
    model.eval()
    runner.check_model()


def test_superchunk_key_tells_the_graphs_apart():
    pipe = port_pipeline(seed=0)
    images = clip()
    keys = set()
    for c, carried in ((0, False), (4, True), (8, True)):
        dev_images, dev_valid = pipe.chunk_inputs(images, c, carried)
        carry = [torch.zeros((2, 4, 4, 8))] * 5 if carried else None
        for masks in (False, True):
            keys.add(graphs.superchunk_key(dev_images, dev_valid, carry, masks))
    assert len(keys) == 2 * 2  # carried x instance masks; the last chunk is a carry chunk
    float_images, dev_valid = pipe.chunk_inputs(clip(np.float32), 0, False)
    assert graphs.superchunk_key(float_images, dev_valid, None, False) not in keys


def test_launches_recorded_while_capturing_count_per_replay():
    """A wrapper's launch while its thread captures goes into the graph's
    count, not the shared one, which counts it once per replay; other
    threads count as usual meanwhile. Threads and a short switch interval
    stress the shared counter."""
    key = ("test", "recording")
    before = cuda_build.launches[key]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        recorded = []

        def capture():
            with cuda_build.recording_launches() as rec:
                for _ in range(200):
                    cuda_build.count_launch(key)
            recorded.append(rec)

        def launch():
            for _ in range(200):
                cuda_build.count_launch(key)

        threads = [threading.Thread(target=f) for f in (capture, launch) * 8]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert [dict(r) for r in recorded] == [{key: 200}] * 8
    assert cuda_build.launches[key] == before + 8 * 200
    for rec in recorded[:3]:
        cuda_build.count_replay(rec)
    assert cuda_build.launches[key] == before + 11 * 200
    del cuda_build.launches[key]


def test_infer_sequence_matches_jax_across_a_carry_chunk():
    """Six frames, a first chunk of 4 and a ragged carry chunk of 2, the
    same weights through `state_dict_from_flax`: the port's
    `infer_sequence` against the JAX package's."""
    jpipe, jmodel = jax_build_pipeline(
        3, 3, HW, min_size=128, max_size=256, dtype=jnp.float32, backbone_batch=SC, chunk=SC, superchunk=SC
    )
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=11)
    images = clip(seed=9)[:6]
    got = port_pipeline(variables).infer_sequence(images)
    want = jpipe.infer_sequence(variables, images)
    assert len(got) == len(want) == 6
    assert any(d["valid"].any() for d in got)
    for g, w in zip(got, want):
        assert g["union_mask"].shape == HW and g["union_mask"].dtype == bool
        assert_detections_close(
            *[(d["boxes"], d["scores"], d["labels"], d["valid"], np.packbits(d["union_mask"], axis=-1)) for d in (g, w)],
            HW[1],
        )
