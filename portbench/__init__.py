"""portbench: the benchmark of the PyTorch and CUDA port
(``medane_tchakorom_ufc_thesis_repository_tpu_torch``) on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Every piece that belongs to one configuration, traffic mix, entry,
per-layer metric or kernel wrapper sits in a file of its own under
``configs/``, ``traffic/``, ``entries/``, ``metrics/`` or ``kernels/``,
found by its name."""
