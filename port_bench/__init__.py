"""The benchmark of ``densebox_tpu_torch`` on one NVIDIA H100.

``python3 -m port_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it
(``port_bench/harness.py``). The yardstick lives here: the traffic
generators, the plain reference (``reference/``), the operation and byte
counts with the table of peaks (``roofline/``), the trace reduction
(``trace.py``) and the comparison that decides ``correct``.
"""
