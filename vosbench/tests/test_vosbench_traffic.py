"""The traffic: the same seed gives the same inputs, every seed the same
sizes in another order, and the training tree reads back through the port's
loader as the reference's own decode reads it."""
import numpy as np
import pytest
import torch

from vosbench.generators import blob_videos as gen
from vosbench.harness import cell_spec
from vosbench.reference import data as ref_data

DAVIS16_VAL = [50, 80, 84, 90, 75, 40, 104, 90, 60, 52, 50, 90, 50, 50, 49, 40, 80, 100, 43, 99]


def test_inference_traffic_is_davis16_val():
    traffic = cell_spec("sf3-3.infer.davis16val")["traffic"]
    assert traffic["lengths"] == DAVIS16_VAL and sum(traffic["lengths"]) == 1376
    lengths = [t for t, _ in gen.plan(traffic, 2**31 + 5)]
    assert sorted(lengths) == sorted(DAVIS16_VAL)
    assert sum(-(-t // 32) for t in lengths) == 53  # 1696 superchunk frames, 19% of them padding


def test_plan_and_passes_are_fixed_by_the_seed():
    traffic = cell_spec("sf3-3.infer.davis16val")["traffic"]
    assert gen.plan(traffic, 7) == gen.plan(traffic, 7)
    assert gen.plan(traffic, 7) != gen.plan(traffic, 8)
    order = gen.passes(traffic, 7, 3)
    assert order == gen.passes(traffic, 7, 3)
    for p in range(3):
        assert sorted(order[20 * p : 20 * (p + 1)]) == list(range(20))
    assert order[:20] != order[20:40]


def test_training_lengths_keep_their_listed_order():
    traffic = cell_spec("sf3-3.train.davis17")["traffic"]
    for seed in (1, 2**31 + 9):
        plan = gen.plan(traffic, seed)
        assert [t for t, _ in plan] == traffic["lengths"]
        assert sorted(k for _, k in plan) == sorted(traffic["objects"])


def test_videos_are_deterministic_and_their_ids_match_the_frames():
    a, ids = gen.video(np.random.default_rng([3, 1, 0]), 4, (40, 64), 3, "cpu")
    b, _ = gen.video(np.random.default_rng([3, 1, 0]), 4, (40, 64), 3, "cpu")
    c, _ = gen.video(np.random.default_rng([4, 1, 0]), 4, (40, 64), 3, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (4, 40, 64, 3) and a.dtype == torch.uint8 and int(ids.max()) <= 3
    assert bool((a[ids > 0] >= 120).all())  # blob colours; the background stays under 80
    assert bool((a[ids == 0] < 80).all())


@pytest.fixture
def tree(tmp_path):
    traffic = {"lengths": [5, 7], "objects": [1, 2], "jpeg_quality": 90}
    names = gen.write_tree(traffic, 11, (60, 100), str(tmp_path), "cpu", threads=2)
    return tmp_path, names


def test_tree_reads_back_through_the_port_and_the_reference(tree):
    from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence
    from slowfast_vos_tpu_torch.data.windows import train_windows

    root, names = tree
    index = DavisIndex(str(root), "train", year="2017")
    assert [s.name for s in index] == names == ref_data.sequence_names(str(root))
    port = [w for info in index for w in train_windows(load_sequence(info, max_gt=3), fast=3, n_center=2)]
    ours = ref_data.first_windows(str(root), len(port), 3, 2, 3)
    assert len(port) == len(ours) == 3 + 4
    for p, r in zip(port, ours):
        assert set(p) == set(r)
        for k in p:
            np.testing.assert_array_equal(p[k], r[k])
    assert port[0]["gt_valid"].any()
