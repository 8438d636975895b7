"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: ``cells/<cell>.json``,
``configs/<config>.json``, ``traffic/<kind>.py``, ``systems/<system>.py``
and ``metrics/<metric>.py``; ``yardstick/`` holds the frozen peaks and
work arithmetic and ``reference/`` the plain PyTorch models that decide
``correct``. Nothing here imports ``jax`` or the JAX package ``repro``.
"""
