"""The benchmark of the PyTorch and CUDA port (``distributed_pathsim_tpu_torch``).

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Each configuration, traffic mix
and per-layer metric is a file of its own under ``configs/``, ``traffic/``
and ``metrics/``, found by the name that ``BENCHMARK.json`` gives it.
Nothing here imports JAX or the JAX package; the reference
(``reference/``) imports nothing of the port either.
"""
