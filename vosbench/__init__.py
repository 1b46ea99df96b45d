"""The benchmark of `slowfast_vos_tpu_torch` on one NVIDIA H100.

`python vosbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line. Each
piece is found by name: a configuration in `configs/<name>.json`, a
traffic mix in `traffic/<name>.json` (which names its generator in
`generators/` and its driver in `drivers/`), a per-layer metric's reader in
`metrics/<name>.py`. `reference/` is the plain PyTorch model that decides
`correct`; `yardstick.py` holds the peaks and the operation and byte
counts. Nothing here imports JAX or the JAX package, and `reference/`
imports nothing of the port.
"""
