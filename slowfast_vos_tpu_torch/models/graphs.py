"""One CUDA graph per superchunk shape: the port's counterpart of the JAX
package's one compiled executable per superchunk (`jax.jit` of
`_superchunk_impl`, `_superchunk_first_impl` and `_superchunk_carry_impl`,
`slowfast_vos_tpu/models/pipeline.py:90-98`).

`Pipeline._superchunk` launches every kernel of a superchunk from Python
(transform, backbone, RPN and K3, SlowFast, RoI heads with K1 and K3 again,
paste, union, packbits). On the card the host's cost per launch, not the
card, sets the pace. `SuperchunkGraphs` runs each superchunk key once
eagerly and captures it, then replays the graph with one launch:

* the key is what fixes the graph: first chunk or carried, the shape and
  dtype of every input, instance masks or the packed union, and the TF32
  switches;
* the first superchunk of a key runs eagerly on the device's capture
  stream, and its outputs are that call's result. The run also warms what
  capture may not do: cuDNN's and cuBLAS's set-up on that stream (cuBLAS
  keeps a workspace per stream for good), K3's once-per-configuration
  `_prepared`. The allocator's cache is then emptied, as
  `torch.cuda.graph` does, since an allocation that fails during a capture
  cannot free cached blocks, and the same call is captured on that stream
  (`capture_error_mode="thread_local"`: member threads of
  `parallel/mesh.py::on_members` keep uploading, allocating and replaying
  while one thread captures; only the capturing thread is held to
  capture's rules). Every pipeline on a device shares that one stream, so
  the warm-ups' cached blocks serve each other, and its lock makes the
  captures on a device take turns;
* every later superchunk of the key copies its inputs into the graph's
  static input tensors (allocated outside the graphs' memory pool),
  replays, and clones the outputs and the carry out before anything else
  can replay. The graphs of one pipeline share one memory pool: they never
  run at once, and nothing but static outputs, cloned at once, outlives a
  replay;
* kernel launches recorded at capture (`ops/cuda_build.py::
  recording_launches`) are counted again at every replay, so the launch
  counts of a run are those of the eager path;
* with the tracer on (`utils/profiling.py::TRACER`), a capture records
  the stage marks of `Pipeline._superchunk` as timing events into the
  graph (its `StageClock`), and `replay` reads the previous replay's stage
  times before each replay, without a synchronize. The key holds the
  tracer's state, so traced and untraced graphs never stand in for each
  other. The runner's spans: `graphs.run` > `graphs.check`,
  `graphs.copy_in`, `graphs.replay`, `graphs.clone`; `graphs.capture`;
* a graph reads the model's parameters and buffers where they were at
  capture. In-place updates (`load_state_dict`, optimizer steps, running
  statistics) are what a replay then computes with; a parameter or buffer
  that moved (`load_state_dict(assign=True)`, `.to()`, a replaced tensor)
  drops every graph, and the next superchunk captures anew. A model in
  train mode raises: the graphs are eval-mode computations.

A capture or replay that fails raises; nothing falls back to the eager
path. One lock per runner serializes its calls, so threads may share a
pipeline (`DeviceParallelInference` over a device list that repeats a
device); threads on their own pipelines run side by side.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref

import torch

from slowfast_vos_tpu_torch.ops import cuda_build
from slowfast_vos_tpu_torch.utils.profiling import TRACER, StageClock

_capture_streams: dict = {}  # device -> (its capture stream, the lock its users take)
_capture_streams_lock = threading.Lock()


def capture_stream(device: torch.device) -> tuple:
    """The device's capture stream and the lock that serializes its use,
    made at the first call for the device: a stream is a process-wide
    resource here (cuBLAS's workspace and the allocator's cached blocks are
    kept per stream)."""
    with _capture_streams_lock:
        if device not in _capture_streams:
            _capture_streams[device] = (torch.cuda.Stream(device), threading.Lock())
        return _capture_streams[device]


@dataclasses.dataclass
class CapturedSuperchunk:
    graph: torch.cuda.CUDAGraph
    inputs: list  # static: the window, feat_valid, the carry's levels
    outputs: tuple  # (detections, carry) as `_superchunk` returns them, in the pool
    launches: dict  # kernel launches per replay, by `cuda_build.launches` key
    capture_s: float
    clock: StageClock | None = None  # the stage marks' events, where captured with the tracer on


def tensor_spec(x: torch.Tensor) -> tuple:
    """What of a tensor fixes a graph that reads it: shape, dtype, strides."""
    return tuple(x.shape), x.dtype, x.stride()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def capture(device: torch.device, pool, run, generators=(), clock: StageClock | None = None) -> tuple:
    """Run `run()` eagerly on the device's capture stream, empty the
    allocator's cache, then capture the same call into a CUDA graph there
    (`capture_error_mode="thread_local"`), all under the stream's lock.
    Kernel launches of the capture, from this thread or onto the capture
    stream from any other (autograd's device thread), are recorded, not
    counted. `generators` (device generators that `run` draws from) are
    registered with the graph, so a replay draws where the generator stands
    and advances it as the eager call does. With a `clock`, the captured
    call's stage marks record their events into it (the eager call's
    record none).

    Returns (the eager call's result, usable on the caller's stream; the
    graph; the captured call's outputs, in `pool`; kernel launches per
    replay; the capture's seconds)."""
    (stream, stream_lock), caller = capture_stream(device), torch.cuda.current_stream(device)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with stream_lock:
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            result = run()
            for t in _tensors(result):  # used on the caller's stream, freed there
                t.record_stream(caller)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with cuda_build.recording_launches(stream.cuda_stream) as launches:
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    with TRACER.recording(clock):
                        outputs = run()
                finally:
                    graph.capture_end()
            capture_s = time.perf_counter() - t0
        caller.wait_stream(stream)
    return result, graph, outputs, dict(launches), capture_s


def replay(captured) -> None:
    """One replay of a captured graph (a `CapturedSuperchunk` or a
    `train/graphs.py::CapturedStep`): the previous replay's stage times read
    first where the graph has marks, the launches it recorded counted."""
    with TRACER.span("graphs.replay"):
        if captured.clock is not None:
            captured.clock.read()
        captured.graph.replay()
        if captured.clock is not None:
            captured.clock.replayed()
        cuda_build.count_replay(captured.launches)


def superchunk_key(images, feat_valid, carry, instance_masks: bool) -> tuple:
    """What fixes a superchunk's graph (see the module docstring)."""
    return (
        tensor_spec(images),
        tensor_spec(feat_valid),
        None if carry is None else tuple(tensor_spec(c) for c in carry),
        instance_masks,
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32,
        TRACER.on,
    )


class SuperchunkGraphs:
    """The CUDA graphs of one `Pipeline`'s superchunks, by `superchunk_key`.
    Created with the pipeline; touches the card only at its first `run`."""

    def __init__(self, pipe):
        self.pipe = weakref.proxy(pipe)  # the pipeline owns the runner: no cycle keeps its graphs alive
        self.graphs: dict[tuple, CapturedSuperchunk] = {}
        self.captures = 0  # graphs captured over the runner's life
        self._lock = threading.Lock()
        self._addresses: tuple | None = None
        self._pool = None

    def weight_addresses(self) -> tuple:
        """Where the model's parameters and buffers, and the pipeline's
        anchors, lie: what a captured graph reads."""
        m = self.pipe.model
        return tuple(t.data_ptr() for t in itertools.chain(m.parameters(), m.buffers(), self.pipe.anchors))

    def check_model(self) -> None:
        """Raise unless the model is in eval mode; drop every graph, and
        their memory pool, where a parameter or buffer moved since the last
        check."""
        if any(m.training for m in self.pipe.model.modules()):
            raise RuntimeError("the superchunk graphs compute in eval mode; call model.eval() before inference")
        addresses = self.weight_addresses()
        if addresses != self._addresses:
            self.graphs.clear()
            self._pool = None
            self._addresses = addresses

    def run(self, images, feat_valid, carry=None, instance_masks: bool = False):
        """`Pipeline._superchunk` on device inputs through the key's graph,
        captured at the key's first call. Returns (outputs, carry), tensors
        the caller owns."""
        with TRACER.span("graphs.run"), self._lock, torch.inference_mode():
            with TRACER.span("graphs.check"):
                key = superchunk_key(images, feat_valid, carry, instance_masks)
                sources = [images, feat_valid, *(carry or ())]
                self.check_model()
                captured = self.graphs.get(key)
            if captured is None:
                with TRACER.span("graphs.capture"):
                    return self._capture(key, sources, instance_masks)
            with TRACER.span("graphs.copy_in"):
                for dst, src in zip(captured.inputs, sources):
                    dst.copy_(src, non_blocking=True)
            replay(captured)
            with TRACER.span("graphs.clone"):
                outs, next_carry = captured.outputs
                return tuple(o.clone() for o in outs), [c.clone() for c in next_carry]

    def _capture(self, key, sources, instance_masks):
        """The key's first superchunk: run eagerly on the capture stream,
        then captured into a graph there. Returns the eager run's outputs."""
        carried = key[2] is not None
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        inputs = [torch.empty_like(s) for s in sources]
        for dst, src in zip(inputs, sources):
            dst.copy_(src, non_blocking=True)

        def superchunk():
            carry = inputs[2:] if carried else None
            return self.pipe._superchunk(inputs[0], inputs[1], carry, instance_masks)

        clock = TRACER.stage_clock(f"superchunk.{'carried' if carried else 'first'}[{sources[0].shape[0]}]")
        result, graph, outputs, launches, capture_s = capture(self.pipe.device, self._pool, superchunk, clock=clock)
        self.graphs[key] = CapturedSuperchunk(graph, inputs, outputs, launches, capture_s, clock)
        self.captures += 1
        return result
