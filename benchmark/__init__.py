"""The benchmark of the PyTorch and CUDA port (`rnnpose_tpu_torch`) on the
H100: `python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once (`run.py`). The
configurations, traffic mixes and metric readers are files of their own
(`configs/`, `traffic/`, `metrics/`); the plain reference that decides
`correct` is a frozen copy of the port's eager modules (`reference/`); the
generators of scenes, weights and requests (`gen.py`), the trace
arithmetic (`trace.py`) and the comparison (`check.py`) live here too, so
that a change to the program cannot move the yardstick. `control.py`
reads the numbers the limits were set from. Nothing here imports JAX or
the JAX package `rnnpose_tpu`."""
