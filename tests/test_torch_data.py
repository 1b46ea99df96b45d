"""The PyTorch port's data layer against the JAX package's, on the same
seeded inputs: the synthetic DAVIS tree, the DAVIS index and sequence
decode (2016 and 2017 layouts), every augmentation transform and sampler,
the OSVOS first-frame dataset, aspect grouping and the frame-level batches;
the training windows, streamed out of a lazily decoded sequence, against
the same windows cut out of the whole sequence's arrays.

Both packages run the same Pillow and OpenCV calls on the same numbers, so
every comparison is exact: arrays equal element for element, files equal
byte for byte."""
import os

import numpy as np
import pytest
from PIL import Image

from slowfast_vos_tpu.data import augment as jax_augment
from slowfast_vos_tpu.data import davis as jax_davis
from slowfast_vos_tpu.data import frames as jax_frames
from slowfast_vos_tpu.data import grouping as jax_grouping
from slowfast_vos_tpu.data.osvos_dataset import OsvosFirstFrameDataset as JaxOsvosDataset
from slowfast_vos_tpu.data.synthetic import make_synthetic_davis as jax_make_synthetic_davis
from slowfast_vos_tpu.data.windows import train_windows as jax_train_windows
from slowfast_vos_tpu_torch.data import augment, davis, frames, grouping
from slowfast_vos_tpu_torch.data.osvos_dataset import OsvosFirstFrameDataset
from slowfast_vos_tpu_torch.data.synthetic import make_synthetic_davis
from slowfast_vos_tpu_torch.data.windows import train_windows

TREES = {
    "2017-train": [dict(num_sequences=2, frames=5, hw=(36, 60), num_objects=2)],
    "2016-val": [dict(num_sequences=2, frames=4, hw=(36, 60), num_objects=1, year="2016", subset="val", seed=7)],
    # a mixed-resolution 2017 tree with a train, a val and an unlisted part
    "mixed": [
        dict(num_sequences=2, frames=3, hw=[(36, 60), (60, 36)], num_objects=2),
        dict(num_sequences=1, frames=3, hw=(40, 40), num_objects=1, subset="val", start=2, seed=5),
        dict(num_sequences=1, frames=2, hw=(36, 60), num_objects=2, subset=None, start=3, seed=6),
    ],
}


def assert_items_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def tree_files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Each tree written by both packages: {name: (port root, JAX root)}."""
    out = {}
    for name, calls in TREES.items():
        roots = []
        for make in (make_synthetic_davis, jax_make_synthetic_davis):
            root = str(tmp_path_factory.mktemp(f"{name}-{make.__module__.split('.')[0]}"))
            names = [make(root, **kw) for kw in calls]
            roots.append((root, names))
        assert roots[0][1] == roots[1][1]
        out[name] = (roots[0][0], roots[1][0])
    return out


@pytest.mark.parametrize("name", list(TREES))
def test_synthetic_tree_matches_jax_file_by_file(trees, name):
    port, jax_root = trees[name]
    got, want = tree_files(port), tree_files(jax_root)
    assert sorted(got) == sorted(want)
    assert any(p.endswith(".jpg") for p in got) and any(p.endswith(".png") for p in got)
    for path in want:
        assert got[path] == want[path], path


SUBSETS = [("2017-train", "train", "2017"), ("2016-val", "val", "2016"), ("mixed", "val", "2017")]


@pytest.mark.parametrize("name,subset,year", SUBSETS)
@pytest.mark.parametrize("single_object", [False, True])
def test_index_and_load_sequence_match_jax(trees, name, subset, year, single_object):
    root = trees[name][1]
    got, want = davis.DavisIndex(root, subset, year=year), jax_davis.DavisIndex(root, subset, year=year)
    assert [(s.name, s.images, s.masks) for s in got] == [(s.name, s.images, s.masks) for s in want]
    for g, w in zip(got, want):
        seq = davis.load_sequence(g, max_gt=3, single_object=single_object)
        ref = jax_davis.load_sequence(w, max_gt=3, single_object=single_object)
        assert seq["name"] == ref["name"]
        assert_items_equal({k: v for k, v in seq.items() if k != "name"}, {k: v for k, v in ref.items() if k != "name"})
        assert seq["gt_valid"].any()


@pytest.mark.parametrize("name,subset,year", SUBSETS)
@pytest.mark.parametrize("fast", [1, 3, 7])
@pytest.mark.parametrize("n_center", [1, 2])
@pytest.mark.parametrize("single_object", [False, True])
def test_streamed_windows_equal_the_eager_ones(trees, name, subset, year, fast, n_center, single_object):
    """`train_windows` over a lazily decoded sequence (each window decoding
    its new frames) against the same function over the whole sequence's
    arrays and the JAX package's eager loader and windows: the same windows
    element for element. The trees' sequences of 2-5 frames are shorter
    than a window at fast 7; each is also cut to its first mask, as OSVOS
    clips are."""
    root = trees[name][1]
    infos = list(davis.DavisIndex(root, subset, year=year))
    infos += [davis.SequenceInfo(s.name, s.images, s.masks[:1]) for s in infos]
    for info in infos:
        def load(loader):
            return loader(info, max_gt=3, single_object=single_object)

        streamed = list(train_windows(load(davis.load_sequence), fast, n_center))
        eager = list(train_windows(dict(load(davis.load_sequence)), fast, n_center))
        want = list(jax_train_windows(load(jax_davis.load_sequence), fast, n_center))
        assert len(streamed) == len(eager) == len(want) == -(-len(info.images) // n_center)
        for s, e, w in zip(streamed, eager, want):
            assert_items_equal(s, w)
            assert_items_equal(e, w)


def annotation_plain(mask, max_gt, single_object=False):
    """`annotation_from_ids` as the JAX package and the reference compute
    it: `np.unique` for the ids, `np.where` for each object's extent."""
    obj_ids = np.unique(mask)
    obj_ids = obj_ids[obj_ids != 0][: 1 if single_object else None]
    boxes = np.zeros((max_gt, 4), np.float32)
    masks = np.zeros((max_gt, *mask.shape), np.uint8)
    valid = np.zeros((max_gt,), bool)
    slot = 0
    for oid in obj_ids:
        if slot >= max_gt:
            break
        ys, xs = np.where(mask == oid)
        if xs.min() < xs.max() and ys.min() < ys.max():
            boxes[slot] = [xs.min(), ys.min(), xs.max(), ys.max()]
            masks[slot] = mask == oid
            valid[slot] = True
            slot += 1
    return boxes, masks, valid


def id_mask(seed, dtype):
    """Blocks of ids (some beyond max_gt), a one-pixel object, a one-row
    and a one-column object (degenerate extents, dropped), ids that skip."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((40, 64), dtype)
    for oid in rng.permutation([1, 2, 3, 5, 9, 200])[: rng.integers(2, 7)]:
        y, x = rng.integers(0, 30), rng.integers(0, 50)
        mask[y : y + rng.integers(2, 10), x : x + rng.integers(2, 14)] = oid
    mask[rng.integers(0, 40), rng.integers(0, 64)] = 7
    mask[rng.integers(0, 40), 3:9] = 4
    mask[5:12, rng.integers(0, 64)] = 6
    return mask


@pytest.mark.parametrize("group_size,rank", [(2, 1), (4, 0), (4, 3), (7, 5)])
def test_a_rank_cuts_only_the_windows_it_takes(tmp_path, group_size, rank):
    """`train/trainer.py::epoch_windows` for one rank of a data-parallel
    group, on a 24-frame sequence in windows of 2 + 2: from
    `wrap_filled_groups` and `local_batch_slice` it takes the same windows
    as from the whole epoch (the wrap-filled last group included), every
    other window is None, and past two ranks it decodes fewer frames (with
    two, every other window of 4 frames at a stride of 2 covers them all)."""
    from slowfast_vos_tpu_torch.train.trainer import epoch_windows, wrap_filled_groups
    from slowfast_vos_tpu_torch.utils.profiling import TRACER

    make_synthetic_davis(str(tmp_path), num_sequences=1, frames=24, hw=(36, 60), num_objects=2)
    index = list(davis.DavisIndex(str(tmp_path), "train", year="2017"))

    def taken(group, n):
        TRACER.enable()
        try:
            windows = list(epoch_windows(index, max_gt=3, fast=3, n_center=2, group_size=group, rank=n))
        finally:
            TRACER.disable()
            frames = TRACER.take()["counters"].get("data.frames", 0)
        return windows, [g[n] for g, _ in wrap_filled_groups(windows, group)], frames

    everything, _, all_frames = taken(1, 0)
    mine, got, frames = taken(group_size, rank)
    want = [g[rank] for g, _ in wrap_filled_groups(everything, group_size)]
    assert len(mine) == len(everything) == 12 and len(got) == len(want) == -(-12 // group_size)
    for g, w in zip(got, want):
        assert_items_equal(g, w)
    assert [w is None for w in mine] == [not (j < group_size - 1 or j % group_size == rank) for j in range(12)]
    assert all_frames == 24 and (frames < 24 if group_size > 2 else frames == 24)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_gt,single_object", [(8, False), (3, False), (8, True)])
def test_annotation_from_ids_matches_the_plain_loop(dtype, seed, max_gt, single_object):
    mask = id_mask(seed, dtype)
    got = davis.annotation_from_ids(mask, max_gt, single_object)
    for g, w in zip(got, annotation_plain(mask, max_gt, single_object), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_a_grey_jpeg_is_converted_to_rgb_as_the_jax_loader_does(tmp_path):
    root = str(tmp_path)
    make_synthetic_davis(root, num_sequences=1, frames=3, hw=(36, 60))
    info = davis.DavisIndex(root, "train").sequences[0]
    Image.open(info.images[1]).convert("L").save(info.images[1])  # a grey JPEG among RGB ones
    seq = davis.load_sequence(info, max_gt=3)
    assert seq.frame(0)["images"].shape == seq.frame(1)["images"].shape == (36, 60, 3)
    assert_items_equal(dict(seq), jax_davis.load_sequence(info, max_gt=3))


def test_named_sequences_and_palette_writer(trees, tmp_path):
    root = trees["2017-train"][1]
    idx = davis.DavisIndex(root, "train", sequences="synth01")
    assert [s.name for s in idx] == ["synth01"]
    ids = np.random.default_rng(0).integers(0, 4, (20, 30)).astype(np.uint8)
    davis.save_palette_mask(ids, str(tmp_path / "a.png"))
    jax_davis.save_palette_mask(ids, str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(davis.DAVIS_PALETTE, jax_davis.DAVIS_PALETTE)


def augment_inputs(seed, h=48, w=64, g=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    masks = np.zeros((g, h, w), np.uint8)
    boxes = np.zeros((g, 4), np.float64)
    for i in range(g):
        x1, y1 = rng.uniform(0, [w - 12, h - 12])
        x2, y2 = x1 + rng.uniform(6, 30), y1 + rng.uniform(6, 30)
        boxes[i] = [x1, y1, min(x2, w - 1), min(y2, h - 1)]
        masks[i, int(y1) : int(boxes[i, 3]), int(x1) : int(boxes[i, 2])] = 1
    return img, masks, boxes


TRANSFORMS = {
    "flip": lambda m: m.Flip(),
    "no-flip": lambda m: m.Flip(flipped=False),
    "scale-up": lambda m: m.Scale(sx=0.23, sy=0.31),
    "scale-down": lambda m: m.Scale(sx=-0.4, sy=-0.17),
    "translate": lambda m: m.Translate(tx=0.27, ty=-0.19),
    "translate-out": lambda m: m.Translate(tx=-0.8, ty=0.75),
    "rotate": lambda m: m.Rotate(angle=23.7),
    "rotate-neg": lambda m: m.Rotate(angle=-141.0),
    "shear": lambda m: m.Shear(sx=0.18),
    "shear-neg": lambda m: m.Shear(sx=-0.27),
    "hsv": lambda m: m.HSVShift(dh=17, ds=-40, dv=90),
    "letterbox": lambda m: m.Letterbox(size=96),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_transform_matches_jax(name, seed):
    img, masks, boxes = augment_inputs(seed)
    got = TRANSFORMS[name](augment).apply(img, masks, boxes)
    want = TRANSFORMS[name](jax_augment).apply(img, masks, boxes)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # the image alone, as the OSVOS neighbour frames are transformed
    np.testing.assert_array_equal(TRANSFORMS[name](augment).apply(img)[0], TRANSFORMS[name](jax_augment).apply(img)[0])


SAMPLERS = {
    "flip": lambda m: m.RandomFlip(0.5),
    "scale": lambda m: m.RandomScale(0.25),
    "scale-diff": lambda m: m.RandomScale((-0.3, 0.2), diff=True),
    "rotate": lambda m: m.RandomRotate(30.0),
    "translate": lambda m: m.RandomTranslate(0.2, diff=True),
    "shear": lambda m: m.RandomShear(0.2),
    "hsv": lambda m: m.RandomHSV(20, 30, (-10, 40)),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_augment_sampler_draws_match_jax(name):
    """The same generator seed gives the same parameters, draw for draw, and
    a chain of draws through `apply_sequence` gives the same outputs."""
    got_rng, want_rng = np.random.default_rng(11), np.random.default_rng(11)
    port, ref = SAMPLERS[name](augment), SAMPLERS[name](jax_augment)
    img, masks, boxes = augment_inputs(3)
    for _ in range(5):
        g, w = port.sample(got_rng), ref.sample(want_rng)
        assert type(g).__name__ == type(w).__name__
        assert vars(g) == vars(w)
        chain_g = [g, augment.Rotate(angle=7.0), augment.Scale(sx=0.1, sy=0.1)]
        chain_w = [w, jax_augment.Rotate(angle=7.0), jax_augment.Scale(sx=0.1, sy=0.1)]
        for a, b in zip(augment.apply_sequence(chain_g, img, masks, boxes), jax_augment.apply_sequence(chain_w, img, masks, boxes)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fast", [1, 3, 4, 7])
def test_osvos_first_frame_items_match_jax(trees, fast):
    """The first 5 items of one epoch, key by key (the flip, rotate and the
    retried scale draws from one shared generator, the reflect padding)."""
    root = trees["2016-val"][1]
    info = davis.DavisIndex(root, "val", year="2016").sequences[0]
    jinfo = jax_davis.DavisIndex(root, "val", year="2016").sequences[0]
    port = OsvosFirstFrameDataset(info, fast, scale=0.4, items_per_epoch=5, max_gt=3, seed=63)
    ref = JaxOsvosDataset(jinfo, fast, scale=0.4, items_per_epoch=5, max_gt=3, seed=63)
    assert len(port) == len(ref) == 5
    for i in range(5):
        item = port[i]
        assert_items_equal(item, ref[i])
        assert item["images"].shape[0] == fast


def test_grouping_matches_jax():
    sizes = [tuple(s) for s in np.random.default_rng(2).integers(20, 120, (40, 2))]
    assert grouping.group_by_aspect_ratio(sizes) == jax_grouping.group_by_aspect_ratio(sizes)
    for shuffle in (False, True):
        assert list(grouping.grouped_batches(sizes, 3, shuffle=shuffle, seed=4)) == list(
            jax_grouping.grouped_batches(sizes, 3, shuffle=shuffle, seed=4)
        )


@pytest.mark.parametrize("name,split", [("mixed", "train"), ("mixed", "val"), ("mixed", "test"), ("2017-train", "train")])
@pytest.mark.parametrize("train_flip", [False, True])
def test_frame_batches_match_jax(trees, name, split, train_flip):
    """`DavisFrameDataset` splits by ImageSet membership and `frame_batches`
    gives the same batches in the same order: aspect-grouped canvases on the
    mixed tree, shuffled sequential on the uniform one, the same flips."""
    root = trees[name][1]
    port = frames.DavisFrameDataset(root, split, max_gt=3)
    ref = jax_frames.DavisFrameDataset(root, split, max_gt=3)
    assert port.frames == ref.frames and len(port) > 0
    assert port.sizes() == ref.sizes()
    for bs in (1, 2):
        got = list(frames.frame_batches(port, bs, seed=9, train_flip=train_flip))
        want = list(jax_frames.frame_batches(ref, bs, seed=9, train_flip=train_flip))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_items_equal(g, w)
