"""The port's weight loader and small modules against the JAX package's, on
the CPU at the tiny set-up (60x100 frames, min 64 / max 128, SlowFast 1-3,
TINY_CFG, superchunk 4, f32):

* `convert/from_torchvision.py::load_init` against JAX `scripts/train.py::
  _load_init`: a full reference `SegmentationModel` `.pth` (Mask R-CNN keys
  prefixed `maskrcnn_model.`, `slow_fast.*`, `num_batches_tracked`
  counters) loads with no unused key; a bare Mask R-CNN file (`.pth`, or the
  port's own checkpoint) leaves `slow_fast.*` at its values and reports it
  untouched; `forward_superchunk` then agrees with JAX's at the slice's
  tolerances (`tests/test_torch_pipeline.py`); a shape mismatch raises;
* `eval/visualize.py`, `eval/coco.py`, `utils/smoothing.py` and
  `utils/profiling.py` on the JAX tests' cases, through both packages."""
import importlib.util
import inspect
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_coco_map
from test_torch_pipeline import assert_detections_close
from torch_port_common import TINY_HW, TINY_KW, noisy_variables
from scripts.train import _load_init
from slowfast_vos_tpu.eval import coco as jax_coco
from slowfast_vos_tpu.eval import visualize as jax_visualize
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu_torch.convert import load_init, state_dict_from_flax
from slowfast_vos_tpu_torch.data import make_synthetic_davis
from slowfast_vos_tpu_torch.eval import coco, visualize
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
from slowfast_vos_tpu_torch.utils import profiling, smoothing
from slowfast_vos_tpu_torch.utils.checkpoint import save_checkpoint

SC = 4


def jax_module(relpath: str):
    """A module of the JAX package loaded from its file alone: importing it
    through `slowfast_vos_tpu.utils` would run that package's `__init__`,
    whose orbax import costs seconds this file does not need."""
    path = pathlib.Path(__file__).resolve().parent.parent / "slowfast_vos_tpu" / relpath
    spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_profiling = jax_module("utils/profiling.py")
jax_smoothing = jax_module("utils/smoothing.py")


def port_pipeline(use_slow_fast=True):
    return build_pipeline(1, 3, dtype=torch.float32, device="cpu", superchunk=SC, use_slow_fast=use_slow_fast, **TINY_KW)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX pipeline, reference weights and another draw as the
    model's init, and its forward on one seeded superchunk."""
    jpipe, jmodel = jax_build_pipeline(1, 3, dtype=jnp.float32, backbone_batch=SC, chunk=SC, superchunk=SC, **TINY_KW)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    images = np.random.default_rng(3).integers(0, 256, (SC + 2, *TINY_HW, 3), dtype=np.uint8)
    valid = np.array([False] + [True] * (SC + 1))
    images[~valid] = 0
    forward = jax.jit(jpipe.forward_superchunk)
    weights = noisy_variables(shapes, seed=21)
    init = jax.tree.map(lambda x: x * np.float32(1.25), weights)  # another set, as cheap to make
    return {
        "pipe": jpipe, "weights": weights, "init": init,
        "weights_sd": state_dict_from_flax(weights), "init_sd": state_dict_from_flax(init),
        "inputs": (images, valid), "forward": lambda v: jax.device_get(forward(v, jnp.asarray(images), jnp.asarray(valid))),
    }


def port_forward(pipe, inputs):
    images, valid = inputs
    return [o.numpy() for o in pipe.forward_superchunk(torch.from_numpy(images), torch.from_numpy(valid))]


def assert_state_dicts_equal(got: dict, want: dict):
    """Equal tensors under the same names, `num_batches_tracked` aside."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if "num_batches_tracked" not in k:
            assert torch.equal(got[k], v), k


def test_reference_pth_loads_with_no_unused_key(jax_side, tmp_path):
    """F1: a full SegmentationModel `.pth` through both loaders."""
    sd = jax_side["weights_sd"]
    full = {(k if k.startswith("slow_fast.") else f"maskrcnn_model.{k}"): v for k, v in sd.items()}
    full["maskrcnn_model.backbone.body.bn1.num_batches_tracked"] = torch.tensor(0)
    path = str(tmp_path / "model_slow_fast_1_3.pth")
    torch.save(full, path)

    pipe, model = port_pipeline()
    report = load_init(path, model)
    counted = [k for k in sd if "num_batches_tracked" not in k]
    assert report == {"converted": len(counted), "unused_source_keys": [], "untouched": [], "migrated": []}
    assert_state_dicts_equal(model.state_dict(), sd)
    want = jax_side["forward"](_load_init(path, jax_side["init"]))
    assert_detections_close(port_forward(pipe, jax_side["inputs"]), want, TINY_HW[1])


def test_maskrcnn_checkpoint_leaves_slow_fast_at_init(jax_side, tmp_path):
    """F2: a bare Mask R-CNN file, as a `.pth` and as the port's own
    checkpoint, into a SlowFast model that starts from JAX's init."""
    bare = {k: v for k, v in jax_side["weights_sd"].items() if not k.startswith("slow_fast.")}
    pth = str(tmp_path / "maskrcnn_model.pth")
    torch.save(bare, pth)
    _, maskrcnn = port_pipeline(use_slow_fast=False)
    maskrcnn.load_state_dict(bare, strict=True)
    own = str(tmp_path / "maskrcnn_model.pt")
    save_checkpoint(own, maskrcnn, meta={"epoch": 0})

    start = jax_side["init_sd"]
    sf = [k for k in start if k.startswith("slow_fast.")]
    want = {**bare, **{k: start[k] for k in sf}}
    for path in (pth, own):
        pipe, model = port_pipeline()
        model.load_state_dict(start, strict=True)
        report = load_init(path, model)
        assert report["unused_source_keys"] == []
        assert sorted(report["untouched"]) == sorted(k for k in sf if "num_batches_tracked" not in k)
        assert report["converted"] == len([k for k in bare if "num_batches_tracked" not in k])
        assert_state_dicts_equal(model.state_dict(), want)

    loaded = _load_init(pth, jax_side["init"])
    assert_state_dicts_equal(model.state_dict(), state_dict_from_flax(loaded))
    assert_detections_close(port_forward(pipe, jax_side["inputs"]), jax_side["forward"](loaded), TINY_HW[1])


def test_shape_mismatch_raises_and_loads_nothing(tmp_path):
    _, model = port_pipeline()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "bad.pth")
    torch.save({"maskrcnn_model.rpn.head.cls_logits.bias": torch.ones(before["rpn.head.cls_logits.bias"].shape),
                "maskrcnn_model.rpn.head.conv.weight": torch.zeros(256, 256, 1, 1)}, path)
    with pytest.raises(ValueError, match="rpn.head.conv.weight"):
        load_init(path, model)
    assert_state_dicts_equal(model.state_dict(), before)


def test_unknown_keys_are_reported_and_newer_layouts_map(tmp_path):
    """A key with no place in the model is reported, not loaded; the nested
    layouts of newer torchvision releases land on the port's names."""
    _, model = port_pipeline()
    sd = model.state_dict()
    w = torch.randn(sd["backbone.fpn.inner_blocks.0.weight"].shape)
    r = torch.randn(sd["rpn.head.conv.weight"].shape)
    m = torch.randn(sd["roi_heads.mask_head.mask_fcn1.weight"].shape)
    path = str(tmp_path / "newer.pth")
    torch.save({"backbone.fpn.inner_blocks.0.0.weight": w, "rpn.head.conv.0.0.weight": r,
                "roi_heads.mask_head.mask_fcn1.0.weight": m, "extra.weight": torch.zeros(3)}, path)
    report = load_init(path, model)
    assert report["converted"] == 3 and report["unused_source_keys"] == ["extra.weight"]
    sd = model.state_dict()
    assert torch.equal(sd["backbone.fpn.inner_blocks.0.weight"], w) and torch.equal(sd["rpn.head.conv.weight"], r)
    assert torch.equal(sd["roi_heads.mask_head.mask_fcn1.weight"], m)


def test_mask_iou_and_overlay_equal_jax():
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    masks = rng.uniform(size=(3, 40, 56)) > 0.6
    boxes = rng.uniform(-5, 60, (3, 4))
    for a, b in ((masks[0], masks[1]), (masks[2], masks[2]), (np.zeros((4, 4)), np.zeros((4, 4)))):
        assert visualize.mask_iou(a, b) == jax_visualize.mask_iou(a, b)
    np.testing.assert_array_equal(visualize.overlay(image, masks, boxes), jax_visualize.overlay(image, masks, boxes))
    np.testing.assert_array_equal(visualize.overlay(image, masks), jax_visualize.overlay(image, masks))


def test_evaluate_with_visualization_matches_jax(jax_side, tmp_path):
    root = str(tmp_path / "davis16")
    make_synthetic_davis(root, num_sequences=1, frames=4, hw=TINY_HW, num_objects=1, year="2016", subset="val", seed=7)
    pipe, model = port_pipeline()
    model.load_state_dict(jax_side["weights_sd"], strict=True)
    got = visualize.evaluate_with_visualization(pipe, davis_root=root, out_dir=str(tmp_path / "port"), save_all_imgs=True)
    want = jax_visualize.evaluate_with_visualization(
        jax_side["pipe"], jax_side["weights"], davis_root=root, out_dir=str(tmp_path / "jax"), save_all_imgs=True
    )
    assert abs(got - want) <= 1e-2
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 4 and names == sorted(p.name for p in (tmp_path / "jax").iterdir())


COCO_CASES = [name for name, fn in inspect.getmembers(test_coco_map, inspect.isfunction) if name.startswith("test_")]


@pytest.mark.parametrize("case", COCO_CASES)
def test_coco_map_equals_jax(case, monkeypatch):
    """Each case of tests/test_coco_map.py, with `coco_map` answering
    through both packages, which must agree within 1e-12."""
    calls = []

    def both(predictions, ground_truths, **kw):
        got, want = coco.coco_map(predictions, ground_truths, **kw), jax_coco.coco_map(predictions, ground_truths, **kw)
        assert got["per_class"].keys() == want["per_class"].keys()
        for g, w in [(got["mAP"], want["mAP"]), (got["AP50"], want["AP50"]),
                     *zip(got["per_class"].values(), want["per_class"].values())]:
            assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-12
        calls.append(case)
        return got

    monkeypatch.setattr(test_coco_map, "coco_map", both)
    getattr(test_coco_map, case)()
    assert calls


def fake_clock(monkeypatch):
    """`time.time` advancing 0.25 s per call, so printed timings agree."""
    ticks = iter(np.arange(0, 1e4, 0.25))
    monkeypatch.setattr(time, "time", lambda: float(next(ticks)))


def test_smoothed_value_matches_jax():
    stats = ("median", "avg", "global_avg", "max", "value")
    for window in (3, 20):
        got, want = smoothing.SmoothedValue(window_size=window), jax_smoothing.SmoothedValue(window_size=window)
        for x in [1.0, 2.0, 3.0, 4.0, 0.5]:
            got.update(x)
            want.update(x, n=1)
            assert [getattr(got, s) for s in stats] == [getattr(want, s) for s in stats]
            assert str(got) == str(want)
        got.synchronize_between_processes()  # no process group: a no-op
        assert got.count == 5 and got.global_avg == want.global_avg


def test_smoothed_value_all_reduce(tmp_path):
    """Inside a process group the count and total are all-reduced (one
    process here: unchanged)."""
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1, rank=0)
    try:
        v = smoothing.SmoothedValue()
        for x in (2.0, 5.0):
            v.update(x)
        v.synchronize_between_processes()
        assert (v.count, v.total) == (2, 7.0)
    finally:
        dist.destroy_process_group()


def test_progress_logger_prints_the_jax_lines(monkeypatch, capsys):
    out = {}
    for name, mod in (("port", smoothing), ("jax", jax_smoothing)):
        fake_clock(monkeypatch)
        log = mod.ProgressLogger()
        for i in log.log_every(range(5), print_freq=2, header="test"):
            log.update(loss=float(i), lr=0.1 * i)
        for i in log.log_every(iter(range(3)), print_freq=2, header="gen"):
            log.update(loss=float(i))
        out[name] = (capsys.readouterr().out, log.meters["loss"].count)
    assert out["port"] == out["jax"]
    assert "test [0/5]" in out["port"][0] and "gen [2]" in out["port"][0] and out["port"][1] == 8


def test_stage_timer_matches_jax_and_waits_only_for_cuda(monkeypatch, capsys, tmp_path):
    """The same totals, counts and report as JAX's StageTimer on the same
    clock; on CPU results it never synchronizes a device."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronized for a CPU result"))
    reports = []
    for mod, result in ((profiling, {"a": [torch.ones(2)], "b": (torch.zeros(1),)}), (jax_profiling, jnp.ones(2))):
        fake_clock(monkeypatch)
        timer = mod.StageTimer()
        with timer.stage("load", result=result):
            pass
        out = timer.time("step", lambda x: x, result)
        timer.time("step", lambda x: x, result)
        assert out is result
        timer.report()
        reports.append((timer.summary(), capsys.readouterr().out))
    assert reports[0] == reports[1]
    assert reports[0][0]["step"]["calls"] == 2

    with profiling.torch_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert list((tmp_path / "trace").glob("*.json"))
