"""The PyTorch port's DAVIS evaluation against the JAX package's: the J&F
metrics, the scorer (2016 and 2017 readers, semi-supervised and
unsupervised with Hungarian matching), the results-tree writer, and a tree
of ground-truth masks used as predictions.

Both sides run the same numpy, OpenCV, scipy and Pillow calls, so metrics
are compared exactly (a float order difference would show as a 1e-12
mismatch; none does) and PNG files byte for byte."""
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from slowfast_vos_tpu.data.synthetic import make_synthetic_davis
from slowfast_vos_tpu.eval import glue as jax_glue
from slowfast_vos_tpu.eval import metrics as jax_metrics
from slowfast_vos_tpu.eval import scorer as jax_scorer
from slowfast_vos_tpu_torch.eval import glue, metrics, scorer


def random_masks(seed, t=4, h=40, w=56):
    """Blob-like binary masks [t, h, w] (random rectangles with holes), an
    annotation and a perturbed segmentation of it, and a void mask."""
    rng = np.random.default_rng(seed)
    ann = np.zeros((t, h, w), bool)
    for f in range(t):
        y0, x0 = rng.integers(0, [h // 2, w // 2])
        ann[f, y0 : y0 + rng.integers(5, h // 2), x0 : x0 + rng.integers(5, w // 2)] = True
        ann[f] ^= rng.uniform(size=(h, w)) < 0.02
    seg = np.roll(ann, rng.integers(-3, 4, 2), axis=(1, 2)) ^ (rng.uniform(size=(t, h, w)) < 0.03)
    seg[-1] = False  # one empty segmentation
    void = rng.uniform(size=(t, h, w)) < 0.05
    return ann, seg, void


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_void", [False, True])
def test_jaccard_and_boundary_f_match_jax(seed, with_void):
    ann, seg, void = random_masks(seed)
    v = void if with_void else None
    np.testing.assert_array_equal(metrics.jaccard(ann, seg, v), jax_metrics.jaccard(ann, seg, v))
    got = metrics.boundary_f_measure(ann, seg, v)
    want = jax_metrics.boundary_f_measure(ann, seg, v)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 0.0 and 0.0 < got[0] < 1.0
    for th in (0.008, 3):
        np.testing.assert_array_equal(metrics.boundary_f_measure(ann, seg, v, th), jax_metrics.boundary_f_measure(ann, seg, v, th))


@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_and_dilation_helpers_match_jax(seed):
    ann, seg, _ = random_masks(seed)
    for r in (0, 1, 4):
        np.testing.assert_array_equal(metrics.disk_kernel(r), jax_metrics.disk_kernel(r))
    for m in (ann[0], seg[1], np.zeros_like(ann[0])):
        b = metrics.seg_to_boundary(m)
        np.testing.assert_array_equal(b, jax_metrics.seg_to_boundary(m))
        k = metrics.disk_kernel(3)
        np.testing.assert_array_equal(metrics.dilate_in_bbox(b, k, 3), jax_metrics.dilate_in_bbox(b, k, 3))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_db_statistics_match_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 4, 7, 30):
        vals = rng.uniform(size=n)
        vals[rng.uniform(size=n) < 0.1] = np.nan
        got, want = metrics.db_statistics(vals), jax_metrics.db_statistics(vals)
        np.testing.assert_array_equal(np.array(got), np.array(want))


# --- the scorer on file trees -------------------------------------------------

TREES = {
    "2016": dict(num_sequences=2, frames=5, hw=(40, 64), num_objects=1, year="2016", subset="val", seed=3),
    "2017": dict(num_sequences=2, frames=5, hw=(40, 64), num_objects=3, year="2017", subset="val", seed=4),
}


@pytest.fixture(scope="module")
def gt_trees(tmp_path_factory):
    out = {}
    for year, kw in TREES.items():
        root = str(tmp_path_factory.mktemp(f"gt{year}"))
        out[year] = (root, make_synthetic_davis(root, **kw))
    return out


def write_random_results(root, names, year, seed, res_dir):
    """Each gt frame's objects shifted and speckled, with one spurious
    proposal in 2017 (ids up to 4 against 3 gt objects)."""
    rng = np.random.default_rng(seed)
    for name in names:
        src = os.path.join(root, "Annotations", "480p", name)
        os.makedirs(os.path.join(res_dir, name))
        for fn in sorted(os.listdir(src)):
            ids = np.array(Image.open(os.path.join(src, fn)))
            ids = np.roll(ids, rng.integers(-4, 5, 2), axis=(0, 1))
            ids[rng.uniform(size=ids.shape) < 0.02] = 0
            path = os.path.join(res_dir, name, fn)
            if year == "2016":
                Image.fromarray(((ids > 0) * 255).astype(np.uint8)).save(path)
            else:
                ids[rng.integers(0, 30) : 40, 50:60] = 4
                Image.fromarray(ids.astype(np.uint8)).save(path)


@pytest.mark.parametrize("year", ["2016", "2017"])
@pytest.mark.parametrize("task", ["semi-supervised", "unsupervised"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scorer_matches_jax(gt_trees, tmp_path, year, task, seed):
    root, names = gt_trees[year]
    res = str(tmp_path / "res")
    write_random_results(root, names, year, seed, res)
    got = scorer.DavisScorer(root, task=task, gt_set="val", year=year).evaluate(res)
    want = jax_scorer.DavisScorer(root, task=task, gt_set="val", year=year).evaluate(res)
    assert got == want
    assert len(got["J"]["M"]) == len(names) * TREES[year]["num_objects"]
    assert 0.0 < np.mean(got["J"]["M"]) < 1.0
    assert scorer.summarize(got) == jax_scorer.summarize(want)


def detections(seed, t=5, h=40, w=64, d=3):
    """Per-frame detection dicts as `infer_sequence(instance_masks=True)`
    gives them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(t):
        masks = rng.uniform(size=(d, h, w)).astype(np.float32) ** 3
        valid = rng.uniform(size=d) < 0.7
        union = ((masks >= 0.5) & valid[:, None, None]).any(0)
        out.append({"boxes": np.zeros((d, 4), np.float32), "scores": rng.uniform(size=d).astype(np.float32),
                    "labels": np.ones(d, np.int32), "valid": valid, "union_mask": union, "masks": masks})
    return out


@pytest.mark.parametrize("year", ["2016", "2017"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_results_writer_matches_jax(tmp_path, year, threshold):
    dets = detections(year == "2017")
    seen = []
    glue._write_sequence_masks(str(tmp_path / "port"), "seq", dets, year, threshold, seen.append)
    jax_glue._write_sequence_masks(str(tmp_path / "jax"), "seq", dets, year, threshold, None)
    assert seen == ["seq"]
    files = sorted(os.listdir(tmp_path / "jax" / "seq"))
    assert files == sorted(os.listdir(tmp_path / "port" / "seq")) == [f"{i:05d}.png" for i in range(5)]
    for fn, det in zip(files, dets):
        got, want = (tmp_path / "port" / "seq" / fn).read_bytes(), (tmp_path / "jax" / "seq" / fn).read_bytes()
        assert got == want, fn
        back = np.array(Image.open(tmp_path / "port" / "seq" / fn))
        union = glue.union_mask(det, threshold)
        np.testing.assert_array_equal(back, union.astype(np.uint8) * (255 if year == "2016" else 1))


@pytest.mark.parametrize("year", ["2016", "2017"])
def test_ground_truth_as_prediction_scores_one(gt_trees, tmp_path, year):
    """A results tree that is the ground truth (2016: its union written by
    the results writer; 2017: the palette annotations themselves) scores
    J&F 1.0 in every statistic."""
    root, names = gt_trees[year]
    res = str(tmp_path / "res")
    for name in names:
        src = os.path.join(root, "Annotations", "480p", name)
        if year == "2017":
            shutil.copytree(src, os.path.join(res, name))
            continue
        dets = [{"union_mask": np.array(Image.open(os.path.join(src, fn))) > 0} for fn in sorted(os.listdir(src))]
        glue._write_sequence_masks(res, name, dets, year, 0.5, None)
    summary = scorer.summarize(scorer.DavisScorer(root, task="unsupervised", gt_set="val", year=year).evaluate(res))
    assert summary["J&F-Mean"] == summary["J-Mean"] == summary["F-Mean"] == 1.0
    assert summary["J-Recall"] == summary["F-Recall"] == 1.0
    assert summary["J-Decay"] == summary["F-Decay"] == 0.0
