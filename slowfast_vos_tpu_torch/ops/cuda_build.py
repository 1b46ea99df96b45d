"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). Libraries go into `build/` beside the package, named by a hash of
the source, and are built at first use: never when a module is imported.

`launches` counts the kernel launches of every wrapper, by key: RoIAlign's
forward by output size (7, 14), its backward by ("backward", output size),
NMS by "nms", the train-mode BatchNorm by "bn" and ("backward", "bn"), and
K7, the attention of `ops/attention.py`, by ("attention", "global") and
("attention", "window"), and K8, the convolution epilogue of
`ops/conv_epilogue.py`, by "epilogue". `chip_smoke.py` reads it to show that a path went
through the kernels. Member threads (`parallel/mesh.py::on_members`) launch
concurrently, so each count is taken under a lock. A wrapper called while
its thread captures a CUDA graph (`recording_launches`), or that launches
onto a stream being captured from another thread (autograd's device thread
runs a captured backward), launches nothing: its launch is recorded into
the graph and counted at each replay (`count_replay`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

launches: collections.Counter = collections.Counter()
_launches_lock = threading.Lock()
_capture = threading.local()  # .recorded: the Counter of the graph this thread captures
_captured_streams: dict = {}  # CUDA stream handle -> the Counter of the graph captured on it


def count_launch(key, stream: int | None = None) -> None:
    """Count one launch of `key`, made onto the CUDA stream handle `stream`."""
    with _launches_lock:
        recorded = getattr(_capture, "recorded", None)
        if recorded is None and stream is not None:
            recorded = _captured_streams.get(stream)
        (launches if recorded is None else recorded)[key] += 1


@contextlib.contextmanager
def recording_launches(stream: int | None = None):
    """Within the block, this thread's kernel launches, and any thread's
    launches onto the CUDA stream handle `stream`, go into the Counter it
    yields (a graph's launches, as they are captured), not `launches`."""
    recorded = collections.Counter()
    with _launches_lock:
        _capture.recorded = recorded
        if stream is not None:
            _captured_streams[stream] = recorded
    try:
        yield recorded
    finally:
        with _launches_lock:
            _capture.recorded = None
            _captured_streams.pop(stream, None)


def count_replay(recorded: collections.Counter) -> None:
    """Count the launches of one replay of a graph that recorded them."""
    with _launches_lock:
        launches.update(recorded)


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> tuple[Path, float, str]:
    """Compile `csrc/<source>` unless its library is already built.
    Returns (library path, build seconds, compiler log)."""
    out = library_path(source)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    path, _, _ = build(source)
    return ctypes.CDLL(str(path))
