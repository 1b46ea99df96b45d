"""The PyTorch port's host utilities: `utils/prefetch.py` under the cases
of `tests/test_prefetch.py` (order, exceptions, close, overlap, RNG draw
order, garbage collection), `utils/metrics.py` under those of
`tests/test_utils.py` (the JSON-lines file and the TensorBoard sink), and
`utils/checkpoint.py` (bitwise round trips)."""
import glob
import json
import threading
import time

import numpy as np
import pytest
import torch

from slowfast_vos_tpu_torch.utils.checkpoint import load_checkpoint, restore_checkpoint, save_checkpoint
from slowfast_vos_tpu_torch.utils.metrics import MetricsLogger
from slowfast_vos_tpu_torch.utils.prefetch import PrefetchIterator, prefetch


def test_order_preserved():
    assert list(prefetch(range(100), depth=3)) == list(range(100))


def test_empty_iterable():
    assert list(prefetch([], depth=2)) == []


def test_exception_propagates_at_consumption_point():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    # terminal: subsequent next() raises StopIteration, thread is gone
    with pytest.raises(StopIteration):
        next(it)


def test_early_close_unblocks_and_joins_producer():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=1)
    assert next(it) == 0
    it.close()  # producer is blocked on a full queue here
    assert not it._thread.is_alive()
    # bounded read-ahead: producer never ran far beyond the queue depth
    assert len(produced) < 10
    it.close()  # idempotent


def test_context_manager_closes_on_break():
    with prefetch(iter(range(1000)), depth=2) as it:
        for v in it:
            if v == 5:
                break
    assert not it._thread.is_alive()


def test_actually_overlaps():
    """Consumer work and producer work overlap: total wall < serial sum."""
    n, d = 8, 0.02

    def gen():
        for i in range(n):
            time.sleep(d)
            yield i

    t0 = time.perf_counter()
    for _ in prefetch(gen(), depth=2):
        time.sleep(d)
    wall = time.perf_counter() - t0
    # Serial would be 2*n*d; perfect overlap ~n*d. 1.5x leaves headroom for
    # thread-scheduling jitter on a loaded host while still proving overlap
    # happened.
    assert wall < 1.5 * n * d


def test_stateful_rng_draw_order_matches_serial():
    """One producer thread preserves a shared-RNG dataset's draw sequence —
    the OSVOS dataset pattern (`data/osvos_dataset.py`'s shared Generator)."""

    class DS:
        def __init__(self):
            self.rng = np.random.default_rng(63)

        def __getitem__(self, i):
            return self.rng.integers(0, 1 << 30)

    ds0 = DS()
    serial = [ds0[i] for i in range(50)]
    ds = DS()
    fetched = list(prefetch((ds[i] for i in range(50)), depth=4))
    assert fetched == serial


def test_close_does_not_advance_source_iterator():
    """close() must not cost one more decode: the producer checks the stop
    flag BEFORE advancing the source, so an early exit (the
    max_steps_per_epoch break in `train/pretrain.py`) never blocks on a full
    item production."""
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=1)
    assert next(it) == 0
    # Let the producer reach its steady state: queue full, blocked in put.
    time.sleep(0.1)
    before = len(produced)
    it.close()
    time.sleep(0.1)
    assert len(produced) == before  # no extra pull after close
    assert before <= 3


def test_abandoned_iterator_is_garbage_collected():
    """The producer thread must not keep the iterator alive: its target is a
    module-level function, so dropping the last reference collects the
    PrefetchIterator and the __del__ backstop stops the producer."""
    import gc
    import weakref

    def gen():
        i = 0
        while True:
            yield i
            i += 1

    it = prefetch(gen(), depth=1)
    assert next(it) == 0
    thread = it._thread
    ref = weakref.ref(it)
    del it
    gc.collect()
    assert ref() is None, "producer thread kept the iterator alive"
    thread.join(timeout=2.0)
    assert not thread.is_alive()


def test_depth_validation():
    with pytest.raises(ValueError):
        PrefetchIterator([1], depth=0)


def test_no_thread_leak_across_many_epochs():
    start = threading.active_count()
    for _ in range(20):
        with prefetch(iter(range(10)), depth=2) as it:
            list(it)
    assert threading.active_count() <= start


def test_metrics_logger_jsonl_and_tensorboard_sink(tmp_path):
    """tensorboard=True mirrors scalars to event files (reference
    SummaryWriter parity, code/train.py:82); the JSON-lines file holds one
    object per scalar."""
    with MetricsLogger(str(tmp_path), "tbtest", tensorboard=True) as lg:
        lg.scalar("train/batch_loss", 1.5, 0)
        lg.scalars({"jf": 0.5, "time": 2.0}, 1, prefix="eval/")
    assert glob.glob(str(tmp_path / "tb-tbtest-*" / "events.out.tfevents.*")), "no TensorBoard event file written"
    lines = [json.loads(ln) for ln in open(lg.path)]
    assert [(r["tag"], r["value"], r["step"]) for r in lines] == [
        ("train/batch_loss", 1.5, 0), ("eval/jf", 0.5, 1), ("eval/time", 2.0, 1)
    ]


def test_metrics_logger_without_tensorboard(tmp_path):
    lg = MetricsLogger(str(tmp_path / "logs"), "plain")
    lg.scalar("a", np.float32(0.25), np.int64(3))
    lg.close()
    assert not glob.glob(str(tmp_path / "logs" / "tb-*"))
    assert json.loads(open(lg.path).read())["value"] == 0.25


class _Trainer:
    """What a checkpoint reads of a `Trainer`."""

    def __init__(self, seed, schedule=False):
        torch.manual_seed(seed)
        self.model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=1.0 if schedule else 0.1, momentum=0.9, weight_decay=1e-4)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, lambda k: 0.1 / (k + 1)) if schedule else None
        self.calls = 0

    def step(self):
        self.model.train()
        self.model(torch.randn(5, 4)).square().sum().backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.scheduler is not None:
            self.scheduler.step()
        self.calls += 1


@pytest.mark.parametrize("schedule", [False, True])
def test_checkpoint_restores_trainer_bitwise(tmp_path, schedule):
    """Weights, momentum buffers, the schedule's position and the call
    counter come back bit for bit, and the restored trainer's next step
    equals the original's."""
    a = _Trainer(0, schedule)
    for _ in range(3):
        a.step()
    save_checkpoint(str(tmp_path / "ck.pt"), a, meta={"epoch": 4, "jf": 0.5})
    b = _Trainer(1, schedule)
    meta = restore_checkpoint(str(tmp_path / "ck.pt"), b)
    assert meta == {"epoch": 4, "jf": 0.5} and b.calls == 3
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"], b.optimizer.state[q]["momentum_buffer"])
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    torch.manual_seed(7)
    a.step()
    torch.manual_seed(7)
    b.step()
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


def test_checkpoint_of_a_model_loads_weights_only(tmp_path):
    a, b = _Trainer(0).model, _Trainer(1).model
    save_checkpoint(str(tmp_path / "m.pt"), a)
    payload = load_checkpoint(str(tmp_path / "m.pt"))
    assert set(payload) == {"model", "meta"} and payload["meta"] == {}
    assert restore_checkpoint(str(tmp_path / "m.pt"), b) == {}
    for v, w in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(v, w)
    with pytest.raises(ValueError, match="model weights only"):
        restore_checkpoint(str(tmp_path / "m.pt"), _Trainer(2))
