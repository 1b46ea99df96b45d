"""The benchmark's arithmetic on fixed inputs: the busy union and idle gaps
of a device trace, percentiles and spreads, and the yardstick's FLOP and
byte counts against the figures the repo has quoted for them."""
import pytest

from vosbench import stats, trace, yardstick
from vosbench.harness import cell_spec


def test_union_length_merges_overlaps_and_touching_intervals():
    assert trace.union_length([]) == 0.0
    assert trace.union_length([(0, 1), (0.5, 2), (3, 4), (4, 4.5)]) == pytest.approx(3.5)
    assert trace.union_length([(5, 6), (0, 10)]) == pytest.approx(10)


def test_idle_gaps_and_their_labels():
    busy = [(1, 2), (1.5, 3), (5, 6)]
    gaps = trace.idle_gaps(busy, 0, 8)
    assert gaps == [(0, 1), (3, 5), (6, 8)]
    spans = [("step", 0, 4), ("next_batch", 4.5, 8), ("loss_fetch", 3.5, 4)]
    labels = trace.label_gaps(gaps, spans)
    # (0, 1) and (3, 5) centre in "step" (0.5) and "loss_fetch"/"step" (4.0: the latest to start wins).
    assert labels == {"step": 1, "loss_fetch": 2, "next_batch": 2}


def test_percentile_matches_linear_interpolation():
    xs = [10, 20, 30, 40, 50]
    assert stats.percentile(xs, 0) == 10
    assert stats.percentile(xs, 50) == 30
    assert stats.percentile(xs, 95) == pytest.approx(48)
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_spread_and_rate():
    xs = [100, 101, 102, 103, 104, 105]
    q1, q3 = 100.75, 104.25  # statistics.quantiles(n=4), "exclusive" method
    assert stats.spread(xs) == pytest.approx((q3 - q1) / 102.5)
    assert stats.rate(300, 2.0) == 150
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_resnet50_at_224_is_about_8_2_gflops():
    assert yardstick.resnet50((224, 224)) / 1e9 == pytest.approx(8.2, rel=0.07)


@pytest.mark.parametrize("config,gflop", [("sf3-3", 842.7), ("sf7-7", 1187.0)])
def test_inference_flops_per_frame(config, gflop):
    cfg = cell_spec(f"{config}.infer.davis16val")["config"]
    assert cfg["canvas_hw"] == (768, 1344)
    assert yardstick.infer_flops_per_frame(cfg) / 1e9 == pytest.approx(gflop, abs=0.05)


def test_k6_step_bound_and_its_32_calls():
    cfg = cell_spec("sf3-3.train.davis17")["config"]
    calls = yardstick.bn_calls(cfg, 2)
    assert len(calls) == 32
    assert max(calls) == (4 * 192 * 336, 192)  # P2's bn_s1, [4, 192, 192, 336]
    assert sum(r * c for r, c in calls) / 1e6 == pytest.approx(216.6, abs=0.05)
    fwd, bwd = yardstick.k6_bound_s(cfg, 2)
    assert fwd * 1e3 == pytest.approx(0.2587, abs=2e-4)
    assert bwd * 1e3 == pytest.approx(0.3880, abs=2e-4)


def test_train_flops_count_backward_where_gradients_flow():
    cfg = cell_spec("sf3-3.train.davis17")["config"]
    canvas = cfg["canvas_hw"]
    frozen = 4 * (yardstick.resnet50(canvas) + yardstick.fpn(canvas)) + 2 * yardstick.rpn_head(canvas)
    slowfast_forward = sum(t * kt * yardstick.conv(hw, k, cin, cout) for hw in yardstick.levels(canvas)[:4]
                           for _, kt, k, cin, cout, t in yardstick.slowfast_layers(3, 3, 2))
    first_input_grads = sum(t * kt * yardstick.conv(hw, k, cin, cout) for hw in yardstick.levels(canvas)[:4]
                            for name, kt, k, cin, cout, t in yardstick.slowfast_layers(3, 3, 2)
                            if name in ("slow_conv1", "fast_conv1"))
    heads = 3 * 2 * (512 * yardstick.box_head_per_roi(2) + 128 * yardstick.mask_head_per_roi(2))
    total = yardstick.train_flops_per_step(cfg, 2)
    assert total == frozen + 3 * slowfast_forward - first_input_grads + heads
    assert total / 1e12 == pytest.approx(5.606, abs=0.001)
    cfg7 = cell_spec("sf7-7.train.davis17")["config"]
    assert yardstick.train_flops_per_step(cfg7, 2) > total  # 8 frames of backbone and 7 taps


def test_k1_bound_is_bytes_bound_at_the_cells_shapes():
    cfg = cell_spec("sf3-3.infer.davis16val")["config"]
    pool7_bytes = 32 * 1000 * 49 * 256 * 2
    assert yardstick.k1_bound_s(1, cfg) == pytest.approx(
        (pool7_bytes + 32 * 10 * 196 * 256 * 2 + 32 * 1010 * 20) / yardstick.PEAK_HBM_BYTES)
    assert yardstick.k1_bound_s(3, cfg) == pytest.approx(3 * yardstick.k1_bound_s(1, cfg))
