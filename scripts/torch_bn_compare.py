#!/usr/bin/env python3
"""Time builds of train-mode BatchNorm (K6) against each other on a training step's own calls, on one NVIDIA GPU.

    python3 scripts/torch_bn_compare.py [--baseline NAME=SOURCE.cu[,CONSTANT=V...] ...] [--rounds 2]
                                        [--plan CONSTANT=V1,V2 ...]

Builds, with nvcc into a temporary directory, each --baseline source: an
older commit's `csrc/batch_norm.cu` or an edited copy, e.g. the
three-kernel design of commit 3c9e5ba,

    git show 3c9e5ba:slowfast_vos_tpu_torch/csrc/batch_norm.cu > build/k6_pr13.cu
    python3 scripts/torch_bn_compare.py --baseline pr13=build/k6_pr13.cu

(`build/` is gitignored, so such copies stay out of commits). "current" is
this checkout's source, as the port builds it. A build is called by its own
convention: this checkout's (`batch_norm_forward_cuda` and
`batch_norm_backward_cuda` with the build in place of the module's own
library: one cooperative launch each on `plan`'s grid),
or the three-kernel one of 3c9e5ba (`sfvos_bn_forward(x, bf16, rows, c,
rows_per_part, parts, ...)`: reduce, finalize, normalize / apply, on that
commit's partition of at most 512 partials of at least 64 rows). A
baseline of this checkout's convention may name plan constants of
`ops/batch_norm.py` to go with it (an edited copy with another
`kThreads` needs `THREADS` to match).
--plan adds the current build with one of `ops/batch_norm.py`'s plan
constants (e.g. TILE_BYTES, MIN_CTA_BYTES, MAX_SLOTS) set to each value
listed ("current@CONSTANT=V"); MAX_SLOTS=1,4 shows what keeping tiles in
shared memory buys.

Keeps the 32 BatchNorm calls of one eager step of chip_smoke.py's phase 3
set-up (DAVIS 480x854, SlowFast 3-3, bf16, seeded weights and window;
`chip_smoke.keeping_bn_calls`), holds every build on every call against
the plain versions at phase 13's tolerances (y against
`batch_norm_normalize` of the build's own statistics, dx by `bn_close`,
dweight and dbias rel 1e-4; each backward on the gradient laid out as
autograd handed it over, a channel slice where it was one), then times
each call's forward and backward
for every build in turns (A B C, C B A, ... for --rounds rounds; CUDA events
around calls queued behind a spin, `chip_smoke.device_ms`), beside
`F.batch_norm(training=True)` (forward, and its backward through autograd),
and counts each build's device kernels per call at P2's `bn_s1` (the
largest call) by name (torch.profiler). As yardsticks of the card's memory
rates one way and both ways, times PyTorch's own `x.sum()` (reads x),
`y.zero_()` (writes y) and `y.copy_(x)` on `bn_s1`'s input. Prints the route and bytes of every
call, the step's sums each way against the bounds, `bn_s1`'s times, the
card's name and power limit and one JSON line; exits 1 if a build
disagrees. Needs CUDA.
"""
import argparse
import contextlib
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402

from slowfast_vos_tpu_torch import data  # noqa: E402
from slowfast_vos_tpu_torch import train as train_mod  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.models import slowfast as sf  # noqa: E402
from slowfast_vos_tpu_torch.ops import batch_norm as pbn  # noqa: E402
from slowfast_vos_tpu_torch.ops import cuda_build  # noqa: E402

# Each design's device kernels by name, (forward, backward).
ONE_KERNEL_NAMES = (("bn_forward_kernel",), ("bn_backward_kernel",))
THREE_KERNEL_NAMES = (("bn_reduce_kernel", "bn_finalize_forward_kernel", "bn_normalize_kernel"),
                      ("bn_reduce_kernel", "bn_finalize_backward_kernel", "bn_apply_kernel"))


def build(name: str, source: pathlib.Path, out_dir: pathlib.Path) -> ctypes.CDLL:
    lib = out_dir / f"{name}.so"
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {name} ptxas: {line.strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def three_kernel_calls(lib: ctypes.CDLL):
    """(forward, backward) through a build of 3c9e5ba's convention, with
    that commit's partition of the rows (f32 partials)."""
    vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.sfvos_bn_forward.argtypes = [vp, ci, cl, ci, ci, ci, vp, vp, vp, vp, cf, cf, cf, ci, vp, vp, vp, vp]
    lib.sfvos_bn_forward.restype = ci
    lib.sfvos_bn_backward.argtypes = [vp, cl, vp, ci, cl, ci, ci, ci, vp, vp, vp, ci, vp, vp, vp, vp, vp, vp]
    lib.sfvos_bn_backward.restype = ci

    def partition(rows):
        per = max(64, -(-rows // 512))
        return per, -(-rows // per)

    def forward(x, weight, bias, running_mean, running_var, eps, momentum=0.9, relu=False):
        t, c, h, w = x.shape
        rows = t * h * w
        per, parts = partition(rows)
        y = torch.empty_like(x, memory_format=torch.channels_last)
        stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
        partials = torch.empty((parts, 2, c), dtype=torch.float32, device=x.device)
        rc = lib.sfvos_bn_forward(
            x.data_ptr(), int(x.dtype == torch.bfloat16), rows, c, per, parts, weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), eps, momentum, 1 - momentum, int(relu), y.data_ptr(),
            stats.data_ptr(), partials.data_ptr(), torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(rc == 0, f"three-kernel forward failed: {rc}")
        return y, stats

    def backward(dy, x, stats, weight, bias, relu=False):
        t, c, h, w = x.shape
        rows = t * h * w
        per, parts = partition(rows)
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        dweight = torch.empty((c,), dtype=torch.float32, device=x.device)
        dbias = torch.empty((c,), dtype=torch.float32, device=x.device)
        partials = torch.empty((parts, 2, c), dtype=torch.float32, device=x.device)
        coef = torch.empty((3, c), dtype=torch.float32, device=x.device)
        rc = lib.sfvos_bn_backward(
            dy.data_ptr(), pbn.row_stride(dy), x.data_ptr(), int(x.dtype == torch.bfloat16), rows, c, per, parts,
            stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), int(relu), dx.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr(), partials.data_ptr(), coef.data_ptr(), torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(rc == 0, f"three-kernel backward failed: {rc}")
        return dx, dweight, dbias

    return forward, backward, THREE_KERNEL_NAMES


@contextlib.contextmanager
def planned(prepared=None, **knobs):
    """Within the block the wrappers call the build `prepared` gives (a
    function of the device index, as `pbn._prepared`; None: the module's
    own library), and `pbn.plan` takes the module constants `knobs` (e.g.
    TILE_BYTES) in place of its own (none: as planned)."""
    saved = {k: getattr(pbn, k) for k in knobs}
    saved_prepared = pbn._prepared
    if prepared is not None:
        pbn._prepared = prepared
    for k, v in knobs.items():
        setattr(pbn, k, v)
    if knobs:
        pbn.plan.cache_clear()
    try:
        yield
    finally:
        pbn._prepared = saved_prepared
        for k, v in saved.items():
            setattr(pbn, k, v)
        if knobs:
            pbn.plan.cache_clear()


def prepared_build(lib: ctypes.CDLL):
    """`pbn._prepared` for another build of this checkout's convention:
    its C interface declared and its shared-memory cap lifted on the
    current device."""
    lib = pbn._bind(lib)
    rc = lib.sfvos_bn_prepare()
    chip_smoke.check(rc == 0, f"sfvos_bn_prepare failed: {rc}")
    return lambda device_index: lib


def current_calls(lib=None, **variant):
    prepared = None if lib is None else prepared_build(lib)

    def forward(*args, **kw):
        with planned(prepared, **variant):
            return pbn.batch_norm_forward_cuda(*args, **kw)

    def backward(*args, **kw):
        with planned(prepared, **variant):
            return pbn.batch_norm_backward_cuda(*args, **kw)

    return forward, backward, ONE_KERNEL_NAMES


def check_build(name, fwd, bwd, calls) -> bool:
    """Phase 13's checks of one build on every call: y against the plain
    normalize of the build's own statistics and dx against the plain
    backward (one bf16 ulp, `bn_close`), the statistics against float64
    (1e-6 of E[x^2]), dweight and dbias rel 1e-4; two calls bit for bit."""
    worst = {"y": 0.0, "dx": 0.0, "stats": 0.0, "params": 0.0}
    repeat = True
    with torch.no_grad():
        for c in calls:
            x, relu, w, b = c["x"], c["relu"], c["weight"], c["bias"]
            outs = []
            for _ in range(2):
                rm, rv = c["running_mean"].clone(), c["running_var"].clone()
                y, stats = fwd(x, w, b, rm, rv, c["bn"].eps, 0.9, relu)
                outs.append([y, stats, rm, rv, *bwd(c["dy_given"], x, stats, w, b, relu)])
            repeat = repeat and all(torch.equal(a, b) for a, b in zip(*outs))
            y, stats, _, _, dx, dw, db = outs[0]
            worst["y"] = max(worst["y"], chip_smoke.bn_close(y, sf.batch_norm_normalize(x, stats, w, b, relu))[1])
            want_dx, want_dw, want_db = sf.batch_norm_train_backward_plain(c["dy"], x, stats, w, b, relu)
            worst["dx"] = max(worst["dx"], chip_smoke.bn_close(dx, want_dx)[1])
            worst["params"] = max(worst["params"], chip_smoke.bn_rel(dw, want_dw), chip_smoke.bn_rel(db, want_db))
            xd = x.double()
            mean64, ex2 = xd.mean(dim=(0, 2, 3)), (xd * xd).mean(dim=(0, 2, 3))
            var64 = (ex2 - mean64 * mean64).clamp(min=0)
            off = torch.maximum((stats[0].double() - mean64).abs(), (stats[1].double() - var64).abs()) / ex2
            worst["stats"] = max(worst["stats"], float(off.max()))
    ok = repeat and worst["y"] <= 1 and worst["dx"] <= 1 and worst["stats"] <= 1e-6 and worst["params"] <= 1e-4
    print(f"check {name}: y {worst['y']:.3f} and dx {worst['dx']:.3f} of their tolerance, statistics "
          f"{worst['stats']:.2e} of E[x^2] against float64 (tol 1e-6), dweight / dbias rel {worst['params']:.2e} "
          f"(tol 1e-4), two calls bitwise equal {repeat}: {'ok' if ok else 'DISAGREES'}", flush=True)
    return ok


def call_fns(builds, c):
    """{build: (forward fn, backward fn)} on call `c`, the backward on the
    statistics of the build's own forward; F.batch_norm's pair as "library"."""
    x, relu, w, b = c["x"], c["relu"], c["weight"], c["bias"]
    out = {}
    for name, (fwd, bwd, _) in builds.items():
        rm, rv = c["running_mean"].clone(), c["running_var"].clone()
        _, stats = fwd(x, w, b, rm, rv, c["bn"].eps, 0.9, relu)
        out[name] = (lambda fwd=fwd, rm=rm, rv=rv: fwd(x, w, b, rm, rv, c["bn"].eps, 0.9, relu),
                     lambda bwd=bwd, stats=stats: bwd(c["dy_given"], x, stats, w, b, relu))
    out["library"] = chip_smoke.library_batch_norm(c)
    return out


def memory_rates(x: torch.Tensor) -> dict:
    """TB/s of PyTorch's read-only, write-only and copy kernels on x's
    bytes (device time, `chip_smoke.device_ms`)."""
    y, nbytes = torch.empty_like(x), x.numel() * x.element_size()
    out = {}
    for name, fn, moved in (("read x.sum()", lambda: x.sum(dtype=torch.float32), nbytes),
                            ("write y.zero_()", y.zero_, nbytes), ("copy y.copy_(x)", lambda: y.copy_(x), 2 * nbytes)):
        out[name] = moved / chip_smoke.device_ms(fn) / 1e9
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=SOURCE.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--plan", action="append", default=[], metavar="CONSTANT=V1,V2",
                    help="a plan constant of ops/batch_norm.py and values for extra runs of the current build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bn_compare: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builds = {"current": current_calls()}
    for spec in args.plan:
        name, values = spec.split("=", 1)
        chip_smoke.check(isinstance(getattr(pbn, name, None), int), f"--plan: {name} is not a plan constant")
        for v in values.split(","):
            builds[f"current@{name}={int(v)}"] = current_calls(**{name: int(v)})
    with tempfile.TemporaryDirectory(prefix="bn_compare_", dir=cuda_build.BUILD_DIR) as tmp:
        for spec in args.baseline:
            name, source = spec.split("=", 1)
            source, *knobs = source.split(",")
            lib = build(name, ROOT / source, pathlib.Path(tmp))
            knobs = {k: int(v) for k, v in (kv.split("=") for kv in knobs)}
            builds[name] = (current_calls(lib, **knobs) if hasattr(lib, "sfvos_bn_prepare")
                            else three_kernel_calls(lib))
        pipe, model, trainer, batch, _ = chip_smoke.full_width_trainer(pipeline_mod, train_mod, data)
        trainer.graphs = None  # a replay calls no Python: the step that keeps the calls runs eagerly
        names = {id(m): n for n, m in model.named_modules()}
        with chip_smoke.keeping_bn_calls() as calls:
            trainer.step(batch)
            torch.cuda.synchronize()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for c in calls:
            x = c["x"]
            rows, ch = x.numel() // x.shape[1], x.shape[1]
            fp, bp = pbn.plan(rows, ch, True, None, sms), pbn.plan(rows, ch, True, c["dy_row_stride"], sms)
            c["plan"] = {"forward": (fp.route, fp.grid, fp.slots), "backward": (bp.route, bp.grid, bp.slots)}
            print(f"call {names[id(c['bn'])]} {list(x.shape)}: {x.numel() * x.element_size() / 1e6:.2f} MB, forward "
                  f"{fp.route} (grid {fp.grid}, {fp.slots} slots of {-(-fp.tiles // fp.grid)} tiles), backward "
                  f"{bp.route} (grid {bp.grid}, {bp.slots} slots), dy row stride {c['dy_row_stride']}", flush=True)
        disagree = {name for name, (fwd, bwd, _) in builds.items() if not check_build(name, fwd, bwd, calls)}
        order = [*builds, "library"]
        per_call = []
        for c in calls:
            fns = call_fns(builds, c)
            times = {name: {"forward": [], "backward": []} for name in order}
            for rnd in range(2 * args.rounds):
                for name in order if rnd % 2 == 0 else order[::-1]:
                    for d, fn in zip(("forward", "backward"), fns[name]):
                        times[name][d].append(chip_smoke.device_ms(fn))
            per_call.append({"name": names[id(c["bn"])], "shape": list(c["x"].shape), "plan": c["plan"],
                             "bounds": chip_smoke.bn_bounds(c["x"]),
                             "ms": {n: {d: statistics.median(v) for d, v in t.items()} for n, t in times.items()}})
        big = max(range(len(calls)), key=lambda i: calls[i]["x"].numel())
        top = per_call[big]
        fns = call_fns(builds, calls[big])
        top["kernels"] = {}
        for name, (_, _, kernel_names) in builds.items():
            for d, fn, kn in zip(("forward", "backward"), fns[name], kernel_names):
                by_name, per = chip_smoke.kernel_ms_by_name(fn, kn)
                top["kernels"][f"{name} {d}"] = {"device_kernels_per_call": per,
                                                 "by_name_ms": {k: v for k, v in by_name.items() if v}}
        step = {n: {d: sum(p["ms"][n][d] for p in per_call) for d in ("forward", "backward")} for n in order}
        rates = memory_rates(calls[big]["x"])
        bound = {d: sum(p["bounds"][d]["bound_ms"] for p in per_call) for d in ("forward", "backward")}
    for d in ("forward", "backward"):
        print(f"step {d}, the {len(calls)} calls summed: " + ", ".join(
            f"{n} {step[n][d]:.4f} ms" for n in order) + f"; bound {bound[d]:.4f} ms", flush=True)
        print(f"bn_s1 {top['shape']} {d}: " + ", ".join(f"{n} {top['ms'][n][d]:.4f} ms" for n in order)
              + f"; bound {top['bounds'][d]['bound_ms']:.4f} ms", flush=True)
    print(f"memory rates on bn_s1's x ({calls[big]['x'].numel() * calls[big]['x'].element_size() / 1e6:.1f} MB), TB/s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in rates.items()), flush=True)
    for k, v in top["kernels"].items():
        print(f"kernels bn_s1 {k}: {v['device_kernels_per_call']:g} device kernels a call, "
              + ", ".join(f"{n} {ms:.4f} ms" for n, ms in v["by_name_ms"].items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "step_ms": step, "step_bound_ms": bound,
                      "memory_rates_tb_s": rates,
                      "bn_s1": top, "per_call": per_call, "disagree": sorted(disagree)}))
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main())
