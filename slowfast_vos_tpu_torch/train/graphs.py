"""One CUDA graph per training-step shape: the port's counterpart of the JAX
package's one compiled train step (`jax.jit(self._step_impl)`,
`slowfast_vos_tpu/train/train_step.py:187`, which holds the loss, its
gradient, the optax update and the BatchNorm statistics).

`Trainer.step` launches some 4,400 kernels from Python at full width, so
the host's cost per launch, not the card, sets its pace. `TrainStepGraphs`
captures the two halves that `Trainer` already splits, each as a graph:

* the gradient graph, `Trainer.device_gradient`: the samplers' draws from
  the trainer's generator, the forward in train mode, the backward into the
  parameters' `.grad` and SlowFast's running statistics. One graph per key:
  the pipeline (its canvas: `use_pipeline` switches it), the shape, dtype
  and strides of every batch field and of the caller's draws (or none:
  drawn in the graph), `n_center` and the TF32 switches;
* the update graph, `Trainer.device_update`: the fused SGD step, which
  reads the learning rate from the trainer's device tensor `lr` (so a
  schedule, stepped on the host, acts on every replay), and the gradients
  zeroed in place.

Callers that work between the halves go on working: the data-parallel
step all-reduces the gradients (`parallel/sharded.py`), OSVOS accumulates
two calls per update. The gradients, momentum buffers and rate lie at fixed
addresses outside the graphs' memory pool (`Trainer.__init__`), and
`Trainer.calls` stays a host counter that a capture never advances.

As in `models/graphs.py` (`capture`), a key's first call runs eagerly on
the device's capture stream, and its result is that call's; the same call
is then captured there. Later calls copy their inputs into the graph's
static inputs, replay, and clone the metrics out. What the capture must
not do happens in that eager run: the optimizer's state and every
constant exist before it, K3's once-per-configuration set-up is done,
cuDNN and cuBLAS are warm on the stream and on autograd's device thread.
The capture executes nothing, so it advances no weight, statistic or
generator.

* Random draws: the trainer's generator is registered with every graph, so
  a replay draws from where the generator stands and moves it on as an
  eager step does: step k draws the same numbers on either path.
* The backward runs on autograd's device thread, not the caller's. Its
  launches onto the capture stream are captured (the mode is
  "thread_local", so other threads keep working meanwhile) and recorded
  for the launch counts; the device's capture lock is held over the whole
  capture, so two trainers on one device (lockstep OSVOS) take turns.
* Weights are read in place, so inference graphs captured before training
  read the trained weights after it. A parameter, buffer, gradient,
  momentum buffer or the rate that moved (a restored optimizer state, a
  replaced parameter) drops every graph and the pool; the next call
  captures anew.
* One memory pool per trainer serves all its graphs: they never run at
  once, and nothing but the metrics, cloned at once, outlives a replay.
  Dropping the trainer frees its graphs and their pool.

With the tracer on (`utils/profiling.py::TRACER`), a capture records the
stage marks of `Trainer.device_gradient` (and the update's) as timing
events into the graph, read before the graph's next replay; the tracer's
state is part of the gradient key, and the update graph is captured anew
where its state differs. Spans: `graphs.run` (the gradient) and
`graphs.update`, each > `graphs.check`, `graphs.replay` (and the
gradient's `graphs.copy_in`, `graphs.clone`); `graphs.capture`.

A capture or replay that fails raises; nothing falls back to the eager
path.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref

import torch

from slowfast_vos_tpu_torch.models.graphs import capture, replay, tensor_spec
from slowfast_vos_tpu_torch.utils.profiling import TRACER, StageClock


@dataclasses.dataclass
class CapturedStep:
    graph: torch.cuda.CUDAGraph
    inputs: list  # static: the batch fields by name, then the caller's draws by name
    outputs: dict  # the metrics as `Trainer.loss` returns them, in the pool (none for the update)
    launches: dict  # kernel launches per replay, by `cuda_build.launches` key
    capture_s: float
    pipe: object = None  # the pipeline a gradient graph reads (canvas, anchors), kept alive with it
    clock: StageClock | None = None  # the stage marks' events, where captured with the tracer on


def step_key(pipe, batch: dict, draws: dict | None, n_center: int) -> tuple:
    """What fixes a gradient graph (see the module docstring)."""
    return (
        id(pipe),
        tuple((k, tensor_spec(batch[k])) for k in sorted(batch)),
        None if draws is None else tuple((k, tensor_spec(draws[k])) for k in sorted(draws)),
        n_center,
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32,
        TRACER.on,
    )


class TrainStepGraphs:
    """The CUDA graphs of one `Trainer`'s steps: gradient graphs by
    `step_key`, and the update graph. Created with the trainer; touches the
    card only at its first call."""

    def __init__(self, trainer):
        self.trainer = weakref.proxy(trainer)  # the trainer owns the runner: no cycle keeps its graphs alive
        self.graphs: dict[tuple, CapturedStep] = {}
        self.update: CapturedStep | None = None
        self.captures = 0  # graphs captured over the runner's life
        self._lock = threading.Lock()
        self._addresses: tuple | None = None
        self._pool = None

    def weight_addresses(self) -> tuple:
        """Where the model's parameters and buffers, the trainable
        parameters' gradients and momentum buffers, and the rate lie: what
        the graphs read and write."""
        tr = self.trainer
        params = list(tr.params.values())
        tensors = itertools.chain(
            tr.model.parameters(), tr.model.buffers(), (p.grad for p in params),
            (tr.optimizer.state[p].get("momentum_buffer") for p in params), (tr.lr,),
        )
        return tuple(None if t is None else t.data_ptr() for t in tensors)

    def check_addresses(self) -> None:
        """Drop every graph, and their memory pool, where a tensor of
        `weight_addresses` moved since the last check."""
        addresses = self.weight_addresses()
        if addresses != self._addresses:
            self.graphs.clear()
            self.update = None
            self._pool = None
            self._addresses = addresses

    def gradient(self, batch: dict[str, torch.Tensor], draws: dict | None = None) -> dict[str, torch.Tensor]:
        """`Trainer.device_gradient` on a staged batch through the key's
        graph, captured at the key's first call. Returns the metrics,
        tensors the caller owns."""
        tr = self.trainer
        with TRACER.span("graphs.run"), self._lock:
            with TRACER.span("graphs.check"):
                names = sorted(batch)
                draw_names = [] if draws is None else sorted(draws)
                sources = [batch[k] for k in names] + [draws[k] for k in draw_names]
                key = step_key(tr.pipe, batch, draws, tr.n_center)
                self.check_addresses()
                captured = self.graphs.get(key)
            if captured is None:
                with TRACER.span("graphs.capture"):
                    return self._capture_gradient(key, names, draw_names, sources, draws is None)
            with TRACER.span("graphs.copy_in"):
                for dst, src in zip(captured.inputs, sources):
                    dst.copy_(src, non_blocking=True)
            replay(captured)
            with TRACER.span("graphs.clone"):
                return {k: v.clone() for k, v in captured.outputs.items()}

    def _capture_gradient(self, key, names, draw_names, sources, drawn: bool) -> dict[str, torch.Tensor]:
        """The key's first call: eager on the capture stream, then captured
        into a graph there. Returns the eager call's metrics."""
        tr = self.trainer
        device = tr.pipe.device
        inputs = [torch.empty(s.shape, dtype=s.dtype, device=device) for s in sources]
        for dst, src in zip(inputs, sources):
            dst.copy_(src, non_blocking=True)

        def gradient():
            static = dict(zip(names + draw_names, inputs))
            return tr.device_gradient({k: static[k] for k in names},
                                      None if drawn else {k: static[k] for k in draw_names})

        clock = TRACER.stage_clock(f"train.gradient[{sources[names.index('images')].shape[0]}]")
        metrics, graph, outputs, launches, capture_s = capture(device, self._pool_handle(), gradient,
                                                               (tr.generator,), clock)
        self.graphs[key] = CapturedStep(graph, inputs, outputs, launches, capture_s, tr.pipe, clock)
        self.captures += 1
        return metrics

    def apply_update(self) -> None:
        """`Trainer.device_update` through the update graph, captured at the
        first call."""
        tr = self.trainer
        with TRACER.span("graphs.update"), self._lock:
            with TRACER.span("graphs.check"):
                self.check_addresses()
                captured = self.update
            if captured is None or (captured.clock is not None) != TRACER.on:

                def update():
                    tr.device_update()
                    return {}

                with TRACER.span("graphs.capture"):
                    clock = TRACER.stage_clock("train.update")
                    _, graph, _, launches, capture_s = capture(tr.pipe.device, self._pool_handle(), update, clock=clock)
                    self.update = CapturedStep(graph, [], {}, launches, capture_s, clock=clock)
                    self.captures += 1
                return
            replay(captured)

    def _pool_handle(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool
