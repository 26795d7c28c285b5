"""The benchmark of ``smart_nanogrid_gym_torch`` on one NVIDIA H100.

``BENCHMARK.json`` at the root names the cells; ``python3 -m nanobench.run``
runs one (see :mod:`nanobench.run`).  Configurations, traffic mixes, drivers
and per-layer metric readers are files of their own under this folder,
found by the names the manifest gives.
"""
