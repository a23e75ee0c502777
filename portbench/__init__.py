"""portbench: the benchmark of kaminpar_tpu_torch on one NVIDIA H100.

One run partitions one cell's graph again and again for a fixed window and
prints one JSON line (`run.py`).  Configurations, traffic mixes, cells and
per-layer metrics are files found by name (`cells.py`); the plain NumPy
reference that decides `correct` lives in `reference/`.  Nothing here
imports JAX or the JAX package `kaminpar_tpu`.
"""
