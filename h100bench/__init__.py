"""The benchmark of ``cigwas_tpu_torch`` on NVIDIA cards.

``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one cell, configuration, traffic mix, entry or per-layer
metric is a file of its own that the harness finds by name:

- ``workloads/<cell>.json``: the cell's configuration, traffic, entry, the
  end-to-end rate it reports and the limits that decide ``correct``;
- ``configs/<config>.json``: the deployment's sizes and its source;
- ``traffic/<traffic>.json``: parameters that a generator in
  ``generators/<generator>.py`` reads;
- ``entries/<entry>.py``: how a solve is set up, run and checked;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

``reference/`` holds the plain reference that decides ``correct``. Nothing
here imports ``jax``, the JAX package or ``chip_smoke``.
"""
